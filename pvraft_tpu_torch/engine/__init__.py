"""Training and evaluation of the port: losses, metrics, learning-rate
schedules, the train and eval steps, and the trainer of both stages."""
