"""Utilities of the port: step timing and tracing, the latent-cache tool."""
