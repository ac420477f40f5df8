"""Set-up seconds: process start to the end of the warm-up command
(imports, CUDA context, inputs, builds, warm-up), less the time spent
making the reference's shuffle file where a run found none cached; host
clock."""


def read(rec):
    return rec.setup_s
