"""setup_s: process start to the start of the window: imports, the
graph, the inputs, the plan, the model and the warm-up steps or requests."""


def read(run):
    return run.setup_s
