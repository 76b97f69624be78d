"""Training: the GAN train and validation steps, their state and optimisers,
LR schedules, checkpoints, metrics and the training loop."""
