"""Training: the GAN train step, its state and optimisers, LR schedules."""
