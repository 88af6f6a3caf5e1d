"""Device and host introspection: the card's name and memory, the
per-device memory record the resource sampler publishes, and the H100's
peak rates.

Reproduces `tpu_tree_search/utils/device_info.py`'s `describe_devices`,
`memory_snapshot`, `host_rss_bytes` and `print_device_info` over
`torch.cuda` (JAX's `apply_platform_override` and `resolve_backend` are
about JAX's platform and have no counterpart). One record per visible
CUDA device: `id` is the device index and `platform` is "gpu";
`bytes_in_use` and `peak_bytes_in_use` are the caching allocator's
`allocated_bytes.all.current` and `.peak` (`torch.cuda.memory_stats`,
which reports nothing, so 0, in a process that has not touched the
card), `bytes_limit` the card's `total_memory`. A card is read through
`torch.cuda` alone, and an error there propagates.

Without a card the one device is the CPU: one record with `platform`
"cpu" and the keys JAX reports for a device without memory stats (no
peak, no limit). Its `bytes_in_use` is this process's resident set:
torch keeps no count of its CPU allocations, where JAX sums the bytes of
its live arrays (`_live_array_bytes`).

JAX reads the backend its run uses (`jax.devices()`); here the caller
names it: `platform="cpu"` gives the CPU record on a host with cards too
(a search whose workers are CPU devices), `"gpu"` the cards, and None
(the default) the cards where there are any, else the CPU.

The peak rates are the H100 SXM's, the denominators of `chip_smoke.py`'s
bounds: `HBM_BYTES_PER_S`, `INT32_OPS_PER_S` and `FP32_OPS_PER_S`.
"""

from __future__ import annotations

import os

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# int32 add/min/max rate of the CUDA cores: 64 results per clock per SM
# (compute capability 9.0), 132 SMs, 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# float32 rate: 128 adds per clock per SM (67 TFLOP/s counts an FMA as
# two); float32 min/max run at most as fast, and an SM issues no more
# than 128 thread-instructions a clock, so 128 per clock bounds a chain of
# float32 adds and maxes however they mix (the LB2 sweep computes in
# float32)
FP32_OPS_PER_S = 128 * 132 * 1.98e9


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _process() -> int:
    from ..parallel import mesh
    return mesh.process_index()


def _on_cpu(platform: str | None) -> bool:
    if platform not in (None, "cpu", "gpu"):
        raise ValueError(f"platform {platform!r}: 'cpu', 'gpu' or None")
    return platform == "cpu" or (platform is None and not _cards())


def describe_devices(platform: str | None = None) -> list[dict]:
    """One record per visible card (platform, kind, process, bytes in
    use and limit), or the CPU's: see the module docstring for
    `platform`."""
    process = _process()
    if _on_cpu(platform):
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "process": process}]
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        stats = torch.cuda.memory_stats(i)
        out.append({"id": i, "platform": "gpu", "kind": props.name,
                    "process": process,
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "bytes_limit": int(props.total_memory)})
    return out


def memory_snapshot(platform: str | None = None) -> list[dict]:
    """Per-device memory record for the resource sampler: `id`,
    `platform`, `bytes_in_use`, and on a card `peak_bytes_in_use` and
    `bytes_limit` (`platform` as in the module docstring)."""
    if _on_cpu(platform):
        return [{"id": 0, "platform": "cpu",
                 "bytes_in_use": int(host_rss_bytes() or 0)}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"id": i, "platform": "gpu",
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory)})
    return out


def host_rss_bytes() -> int | None:
    """This process's resident set size in bytes (Linux /proc, with a
    getrusage fallback); None when neither source exists."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss_kib) * 1024      # peak, not current: best effort
    except Exception:  # noqa: BLE001
        return None


def print_device_info() -> None:
    """The `devices` command: one line per device, in the JAX CLI's
    format."""
    for rec in describe_devices():
        line = (f"Device {rec['id']}: {rec['platform']} ({rec['kind']}) "
                f"process {rec['process']}")
        if rec.get("bytes_limit"):
            line += (f", HBM {(rec.get('bytes_in_use') or 0) / 2**30:.2f}/"
                     f"{rec['bytes_limit'] / 2**30:.2f} GiB")
        print(line)
