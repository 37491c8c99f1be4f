"""Host ms per step of plan_batch, PlanCache.key_for and batch_to_device, timed
by the harness around its calls in the traced window (routing and driver
layers)."""


def read(r):
    return r.mean_ms("plan_upload")
