"""Mean time to first token, ms: over every request whose first token
came in the window, first token minus submit on the lifecycle's clock."""


def read(run):
    ttft = [r.first_token_t - r.submit_t for r in run.requests
            if r.first_token_t is not None
            and run.in_window(r.first_token_t)]
    return 1e3 * sum(ttft) / len(ttft) if ttft else None
