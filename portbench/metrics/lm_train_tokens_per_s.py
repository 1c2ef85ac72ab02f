"""Every token of every step completed in the window, over the window."""


def read(run):
    if run.unit != "tokens":
        return None
    return run.units_per_step * run.steps / run.window_s
