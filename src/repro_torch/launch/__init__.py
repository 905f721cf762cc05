"""Launchers of the PyTorch package. So far: the serving launcher."""
