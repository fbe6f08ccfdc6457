"""task_rounds_per_s: every task-round that the window's runs completed
(cells x tasks x rounds a run) over the whole window's host time, from its
first run's start to the end of the run that straddles its close."""


def read(run):
    if not run.runs or run.window_s <= 0:
        return None
    return sum(r.task_rounds for r in run.runs) / run.window_s
