"""VAE codec, DDIM, the SD pipeline subset, the refiner and the JAX-param bridge."""
