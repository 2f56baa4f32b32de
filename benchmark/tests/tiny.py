"""Cells at tiny widths for the CPU tests: the same drivers and checks,
every width cut so that a run takes seconds on the host."""

from __future__ import annotations

import copy
import time

from benchmark import harness

SERVING = {
    "frame_size": 16,
    "transformer": {"dim_model": 32, "num_heads": 2, "num_encoder_layers": 1,
                    "num_decoder_layers": 1, "dim_feedforward": 64,
                    "dropout_p": 0.1, "window": 5},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 32], "layers_per_block": 1,
            "norm_num_groups": 8},
    "unet": {"in_channels": 4, "out_channels": 4,
             "block_out_channels": [16, 32], "layers_per_block": 1,
             "attention_heads": 2, "cross_attention_dim": 16,
             "norm_num_groups": 8, "norm_eps": 1e-05},
    "clip": {"vocab_size": 49408, "hidden_size": 16, "num_layers": 1,
             "num_heads": 2, "intermediate_size": 32, "max_length": 77,
             "layer_norm_eps": 1e-05},
    "refiner": {"hi_res": 32, "start_step": 40, "num_inference_steps": 50,
                "sampler": "ddim"},
}
TRAIN = {"transformer": {"dim_model": 32, "num_heads": 2,
                         "num_encoder_layers": 1, "num_decoder_layers": 1,
                         "dim_feedforward": 2048, "dropout_p": 0.1}}
TRAFFIC = {"sd14_refine_b8": {"clips_per_request": 2, "frame_size": 16,
                              "check_requests": 1},
           "sd14_refine_b1_serve": {"frame_size": 16, "check_requests": 2,
                                    "warm_s": 0},
           "train_b6": {"clips_per_step": 2, "frame_size": 32, "pool": 4}}


def run(cell: str, seed: int = 7, seconds: float = 0.5,
        limits: dict | None = None) -> harness.Run:
    """The cell's Run at tiny widths on the CPU (not yet driven)."""
    r = harness.load_run(cell, seed, seconds, False, time.perf_counter(),
                         device="cpu")
    r.config = copy.deepcopy(r.config)
    r.config.update(copy.deepcopy(SERVING if "sd14" in cell else TRAIN))
    r.traffic = dict(r.traffic, **TRAFFIC[cell])
    r.cell = dict(r.cell, limits=limits or {
        k: 1e-3 for k in r.cell["limits"]})
    return r


def four_ranks(r: harness.Run) -> harness.Run:
    """``r``, a training cell's tiny Run, across four ranks: rank 0 in
    this process, ranks 1-3 in processes of their own, over gloo."""
    r.cell = dict(r.cell, chips=4)
    r.traffic = dict(r.traffic, clips_per_step=4, chunk=2)
    return r


def drive(r: harness.Run) -> harness.Run:
    harness.driver(r.cell["driver"]).run(r)
    return r
