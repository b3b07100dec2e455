"""host_cpu_ms_per_pass: the process's CPU time (time.process_time) over
the window's passes, less the traced stretch, divided by those passes."""


def read(rec, cell):
    if rec.host_passes <= 0:
        return None
    return 1e3 * rec.host_cpu_s / rec.host_passes
