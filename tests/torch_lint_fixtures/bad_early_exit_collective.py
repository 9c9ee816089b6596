"""KNOWN-BAD: a process-dependent early exit with a collective after it.

The main process leaves the function before the preemption vote; its peers
enter the vote's all-reduce and wait for it.
"""


def end_of_epoch(is_main_process, preempt, log):
    if not is_main_process():
        log("not the writer")
        return False
    return preempt.requested_global()
