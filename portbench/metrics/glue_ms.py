"""Device ms per item (a view or a step) of the kernels that are neither
the port's own nor library convolutions or products (glue.json), in the
traced window (model and volume layers); every ``glue_ms.<cell kind>``."""


def read(r):
    return r.glue_ms()
