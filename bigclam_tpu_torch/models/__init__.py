"""The BigCLAM trainers (dense and sparse) and the AGM graph generator."""
