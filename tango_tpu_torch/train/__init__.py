"""SFT training: the data loader and the trainer."""
