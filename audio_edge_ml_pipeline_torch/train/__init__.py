"""Training, selection and evaluation of the port (counterpart of the JAX package's ``train/``)."""
