"""The model's FLOPs of the stretch's items (a view's forward, or a step's
three forwards, counted from shapes, portbench/flops.py) over its seconds,
as a share (%) of the card's dense bf16 peak (device layer, whole step);
every ``mfu.<cell kind>``."""


def read(r):
    return r.mfu()
