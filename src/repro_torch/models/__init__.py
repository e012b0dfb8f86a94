from repro_torch.models.transformer import (
    RunFlags,
    init_cache,
    init_params,
    make_decode_fn,
    make_loss_fn,
    make_prefill_fn,
    padded_vocab,
)

__all__ = ["RunFlags", "init_cache", "init_params", "make_decode_fn",
           "make_loss_fn", "make_prefill_fn", "padded_vocab"]
