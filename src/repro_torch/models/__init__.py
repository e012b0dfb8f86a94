from repro_torch.models.transformer import (
    RunFlags,
    init_params,
    make_loss_fn,
    padded_vocab,
)

__all__ = ["RunFlags", "init_params", "make_loss_fn", "padded_vocab"]
