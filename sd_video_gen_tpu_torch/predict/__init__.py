"""Prediction entry point and the serving loop."""
