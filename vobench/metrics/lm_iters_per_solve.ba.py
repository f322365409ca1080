"""LM iterations per batched BA solve: the largest ``BAResult.n_iter`` of
each traced solve (the batch loops until its slowest window is done),
averaged over the solves."""


def read(ctx):
    return sum(ctx.lm_iters) / len(ctx.lm_iters) if ctx.lm_iters else None
