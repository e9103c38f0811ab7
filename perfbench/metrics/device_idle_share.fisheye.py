"""The device's idle share of the traced window under the lens, in %: 1 -
(union of the device operations' intervals) / window, from
``torch.profiler``."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
