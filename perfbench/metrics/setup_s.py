"""setup_s: seconds from the process's start to the first timed request
or step: imports, building or loading the kernels, making the weights,
warming the cell's shapes. Host clock."""


def read(run):
    return run.setup_s
