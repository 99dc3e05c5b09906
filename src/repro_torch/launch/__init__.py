"""Launch helpers of the port (model serving)."""
