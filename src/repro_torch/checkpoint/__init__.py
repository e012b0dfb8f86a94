from repro_torch.checkpoint.manager import CheckpointManager, load_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint"]
