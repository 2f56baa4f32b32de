"""Examples of the port: ``ball_demo`` (train and beat the copy baseline)
and ``serving_demo`` (many streams through the cached rollout)."""
