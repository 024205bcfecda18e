"""Utilities of the port: the experiment logs and TensorBoard scalars
(``logging.py``)."""
