"""Local mapper: keyframes inserted over frames fed in the window, %."""


def read(ctx):
    if not ctx["attempted"]:
        return None
    return 100.0 * ctx["keyframes"] / ctx["attempted"]
