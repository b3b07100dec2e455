"""samples_per_s: pixel samples of every pass finished in the window over
the window (host clock, from the call that opens it to the return of the
call that closes it), in millions a second."""


def read(rec, cell):
    if rec.window_s <= 0.0:
        return None
    return rec.samples / rec.window_s / 1e6
