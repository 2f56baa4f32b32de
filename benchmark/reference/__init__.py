"""The benchmark's plain reference: the models and the arithmetic of a
serving request and of a training step, in plain PyTorch and float32.

A frozen copy of the published architectures as the measured program runs
them (the FrameTransformer, the SD-v1.4 VAE, UNet and CLIP text encoder,
DDIM, the refiner's pixel round trip, the three training losses and Adam in
optax's order), with every hand-written kernel replaced by plain math and
no sharding, compiled program or cache. It imports nothing of the measured
program: the benchmark hands both sides the same inputs and weights, and
the reference works out everything else again.

``layers.lowered("fp8")`` runs the same code with every product in float8
as FP8 training runs it (operands e4m3, the backward's gradients e5m2, one
scale a tensor): the control that the correctness limits are set against.
"""
