"""Host ms per InferenceRunner.route call, timed by the harness around the
calls of the traced window (routing layer); every ``route_ms.<cell
kind>``."""


def read(r):
    return r.mean_ms("route")
