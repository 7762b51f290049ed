"""Training: the train step, its optimizer, checkpoints and loops."""
