"""Device ms per frame launched by the model's modules (encoders, bottleneck,
decoders and assembler, colour calibration, background), backward included."""

from benchmark.harness import readers


def read(rec):
    return readers.module_ms(rec, "render", readers.MODEL_MODULES)
