"""Weight conversion and initialisation."""
