"""Share (%) of the traced window's steady stretch in which nothing runs on
the device (device layer); every ``idle_pct.<cell kind>``."""


def read(r):
    return r.idle_pct()
