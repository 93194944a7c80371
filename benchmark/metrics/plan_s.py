"""plan_s: host seconds of the port's make_operator, ended by a
synchronize."""


def read(run):
    return run.plan_s
