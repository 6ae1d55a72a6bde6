"""`setup_s`: process start to the window's opening (imports, the kernels'
load or build, images, weights, the service and its warm-up, the
pre-roll), less the seconds that the plain reference spent on the weights'
data-dependent start, which the program does not do."""

UNIT = "s"


def read(record: dict):
    return record["window"].start - record["started"] - record["reference_s"]
