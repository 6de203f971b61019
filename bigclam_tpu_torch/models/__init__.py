"""The BigCLAM trainer and the AGM graph generator."""
