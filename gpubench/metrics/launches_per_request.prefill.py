"""Launch API calls the host made in the traced requests, a request."""


def read(ctx):
    if "traced_requests" not in ctx:
        return None
    return ctx["summary"].launches / ctx["traced_requests"]
