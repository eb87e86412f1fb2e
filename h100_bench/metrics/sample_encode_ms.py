"""Host milliseconds a batch spends in ``OmicsSampleEncoder.encode_test``
(the harness's span around each call in the iterable handed to
``run_batches``), averaged over the window's batches of a traced run."""


def read(record):
    batches = record.get("batches") or []
    if record.get("trace") is None or not batches:
        return None
    return 1e3 * sum(b["encode_test_s"] for b in batches) / len(batches)
