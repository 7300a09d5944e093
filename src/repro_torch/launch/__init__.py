"""Entry points of the port: ``launch.serve`` (LLM serving)."""
