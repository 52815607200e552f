"""The card's idle share of the profiled sub-window: 100 minus the union
of its device operations' intervals over the window's length."""


def read(record):
    s = record.get('trace', {})
    if not s or s.get('window_s', 0) <= 0:
        return None
    return 100.0 * (1.0 - s['busy_s'] / s['window_s'])
