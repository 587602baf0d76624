"""The inputs that the sharded model's remat saves: a spy on
`repro_torch.models.model`'s `checkpoint` of a block, for the sharded
tests' rank functions (`tests/test_torch_sharded_*.py`)."""
import contextlib


@contextlib.contextmanager
def remat_inputs():
    """Within the block, each block that `loss_fn` checkpoints (with
    `cfg.remat`) appends (kind, the shape of the input x that its
    checkpoint keeps for the backward, whether it cross-attends to a
    memory) to the list yielded, in call order (the encoder's blocks
    first)."""
    import repro_torch.models.model as MM

    seen = []
    real = MM.checkpoint

    def spy(fn, *args, **kw):
        if fn is MM._train_block:
            _, _, kind, x, _, memory = args[:6]
            seen.append((kind, tuple(x.shape), memory is not None))
        return real(fn, *args, **kw)

    MM.checkpoint = spy
    try:
        yield seen
    finally:
        MM.checkpoint = real
