"""``torch.cuda.max_memory_allocated()`` in GiB over set-up, the window and
the steps the check waits for after it (through the window's first day end,
the step that holds the most), so that it does not hang on whether the
window reached that step."""


def read(run):
    return run.peak_bytes / 2 ** 30
