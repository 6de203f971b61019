"""Device and dtype policy."""
