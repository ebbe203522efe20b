"""Entry points: the training loop and offline inference with evaluation."""
