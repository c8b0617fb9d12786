"""Entry-point CLIs."""
