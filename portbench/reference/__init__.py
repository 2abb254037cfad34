"""The plain reference: float64 torch and numpy, nothing of the port."""
