"""Optional logging callbacks. Port of
``nnx_ppo_tpu/algorithms/callbacks.py`` (``wandb_video_fn``, 40 lines)."""

from __future__ import annotations

from typing import Callable

import numpy as np

from nnx_ppo_tpu_torch.algorithms.config import VideoData


def wandb_video_fn(
    fps: int = 30, caption_prefix: str = "eval"
) -> Callable[[VideoData], None]:
    """Video callback logging to Weights & Biases.

    Converts frames THWC → TCHW and logs a ``wandb.Video``. wandb is
    imported inside the callback only, so the dependency stays optional.
    """

    def video_fn(video_data: VideoData) -> None:
        import wandb  # only when a video is logged: an optional dependency

        frames = np.transpose(video_data.frames, (0, 3, 1, 2))  # THWC→TCHW
        wandb.log(
            {
                "video": wandb.Video(
                    frames,
                    fps=fps,
                    caption=(
                        f"{caption_prefix} @ step {video_data.step}, "
                        f"reward {video_data.episode_reward:.1f}"
                    ),
                )
            },
            step=video_data.step,
        )

    return video_fn
