"""Training substrate of the port: optimizers, train step, gradient compression."""
