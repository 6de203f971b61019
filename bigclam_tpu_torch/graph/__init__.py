"""Graph containers and ingest."""
