"""A roofline share: the least time the card could take for an operation's
calls in the profiled slice (``roofline/<operation>.py`` from the shapes
the harness made) over the device time of the kernels that its data file
(``roofline/<operation>.json``) names. None when the slice ran none of
them. ``args`` follow the configuration to the operation's ``calls``."""

import importlib.util
import json

from h100_bench.harness.peaks import bound_s


def share(record, operation, *args):
    summary, batch = record.get("trace"), record.get("profiled")
    if summary is None or batch is None:
        return None
    shape = batch["shape"]
    folder = record["bench_dir"] / "roofline"
    spec = importlib.util.spec_from_file_location(
        f"_bench_roofline_{operation}", folder / f"{operation}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(folder / f"{operation}.json") as f:
        data = json.load(f)
    calls = mod.calls(shape, record["config"], *args)
    seconds = summary.kernel_seconds(data["kernels"])
    if not calls or seconds <= 0:
        return None
    bound = sum(bound_s(flops, nbytes, data["peak"])
                for flops, nbytes in calls)
    return 100.0 * bound / seconds
