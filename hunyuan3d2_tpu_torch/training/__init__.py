"""Flow-matching training for the shape DiT (port of hunyuan3d2_tpu/training)."""

from hunyuan3d2_tpu_torch.training.flow_match import flow_match_loss, make_train_step

__all__ = ["flow_match_loss", "make_train_step"]
