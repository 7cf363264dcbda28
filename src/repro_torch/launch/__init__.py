"""Entry points of the port: the training launcher and its session bootstrap."""
