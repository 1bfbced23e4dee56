"""Entry points of the port: the train driver (``train``)."""
