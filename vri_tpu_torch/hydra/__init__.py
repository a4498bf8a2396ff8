"""Hydra-style scene sync over the port's registry."""
