"""IO layers (parity: layers/io.py): the `data` feed declaration, copied from
the JAX package's ``layers/io.py``.  Its py_reader family waits for the
port's ``reader.py`` (ROADMAP Queue 1 item 4)."""

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Parity: layers/io.py data — declares a feed variable.  The leading
    batch dim is dynamic (-1) when append_batch_size is True."""
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    block = default_main_program().global_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=tuple(full_shape),
        dtype=dtype,
        lod_level=lod_level,
        is_data=True,
        stop_gradient=stop_gradient,
    )
