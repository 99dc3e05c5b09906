"""Models of the port: the dense transformer serve path (list layout)."""
