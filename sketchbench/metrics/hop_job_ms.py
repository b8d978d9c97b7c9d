"""hop_job_ms: the window's length (its start to the end of its last job)
over the jobs it completed, milliseconds."""


def read(run):
    done = sum(1 for s in run.steps if not s.failed)
    return 1e3 * run.window_s / done if done else None
