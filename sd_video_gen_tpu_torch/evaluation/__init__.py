"""FVD evaluation: I3D features, Fréchet distance and the evaluation CLIs."""
