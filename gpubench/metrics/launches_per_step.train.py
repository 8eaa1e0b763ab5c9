"""Launch API calls the host made in the traced train steps, a step."""


def read(ctx):
    if "traced_steps" not in ctx:
        return None
    return ctx["summary"].launches / ctx["traced_steps"]
