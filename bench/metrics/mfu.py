"""Model FLOPs utilisation of the whole step: the benchmark's FLOPs a token
(the configuration's reference module: 6 × parameters plus attention's
products; no recomputation) times the tokens of the window's
untraced steps, over their time, over chips × the card's float32 peak
outside the tensor cores (the port trains in f32 with TF32 off)."""


def read(run):
    if run["peaks"] is None:
        return None
    steps = [s for s in run["steps"] if not s["traced"]]
    t0 = run["t_untraced"] or run["t_start"]
    if not steps:
        steps, t0 = run["steps"], run["t_start"]
    if not steps:
        return None
    tokens = sum(s["tokens"] for s in steps)
    rate = run["flops_per_token"] * tokens / (steps[-1]["t1"] - t0)
    return 100.0 * rate / (run["chips"] * run["peaks"]["f32_flops_per_s"])
