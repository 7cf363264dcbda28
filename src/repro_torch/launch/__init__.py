"""Entry points of the port: the training, elastic and serving launchers
and their session bootstrap."""
