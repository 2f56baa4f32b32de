from sd_video_gen_tpu_torch.data.frame_datasets import (
    BouncingBallDataset, KittiDataset, MovingMNISTDataset,
)
from sd_video_gen_tpu_torch.data.pipeline import BatchLoader
from sd_video_gen_tpu_torch.data.synthetic import generate_bouncing_ball_tree
