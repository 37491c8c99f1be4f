"""Host ms a view in the prep thread's resize (`scale_operation`) and bf16
cast (`to_bf16`) of the view's frames, timed by the harness around those
calls in the traced window (driver layer); every ``prep_ms.<cell kind>``."""


def read(r):
    return r.per_item_ms("prep", r.items)
