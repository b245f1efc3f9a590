"""The plain reference: numpy and scipy only."""
