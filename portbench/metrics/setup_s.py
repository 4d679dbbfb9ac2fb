"""setup_s: process start to the start of the measured serve (CUDA,
weights made on the card, the quantization stage, the warm-up serve)."""


def read(ctx):
    return ctx.setup_s
