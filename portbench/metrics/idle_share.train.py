"""The share of the traced window in which no kernel or copy ran on the
card. In %."""


def read(run):
    t = run.tracer
    if not t.traced:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
