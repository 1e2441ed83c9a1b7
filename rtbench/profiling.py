"""The traced loop's profile, read into plain lists for the per-layer
metrics' readers: the device's operations (kernels, copies and sets) and
the host's, on one clock, the traced window, the union of device-busy
intervals, and the breakdown of device time and idle gaps."""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

WINDOW = "rtbench.window"
FRAME = "rtbench.frame"
# host operations whose spans the copy readers look in, with their
# operands' shapes (the profile records shapes)
COPY_OPS = ("aten::copy_", "aten::_to_copy")


class DeviceOp(NamedTuple):
    name: str
    start: int          # ns
    end: int            # ns
    kind: str           # "kernel", "memcpy" or "memset"
    issued: int         # ns: when the host's runtime call issued it, or start


def _kind(e) -> Optional[str]:
    """A device event's kind: "memcpy", "memset", "kernel", or None for an
    annotation (older profilers name no activity type)."""
    a = e.activity_type().lower() if hasattr(e, "activity_type") else ""
    n = e.name().lower()
    if "memcpy" in a or n.startswith("memcpy"):
        return "memcpy"
    if "memset" in a or n.startswith("memset"):
        return "memset"
    if "annotation" in a or e.is_user_annotation():
        return None
    return "kernel" if "kernel" in a or not a else None


def _shapes(e) -> list:
    try:
        return [list(s) for s in e.shapes()]
    except (AttributeError, RuntimeError):
        return []


def short_name(name: str) -> str:
    """A kernel's qualified function name without return type, anonymous
    namespace, template or arguments (``void ns::f<...>(...)`` ->
    ``ns::f``)."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    depth, out = 0, []
    for ch in head:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    words = "".join(out).split()
    return words[-1] if words else name


def function_name(name: str) -> str:
    """The unqualified function name of a kernel (``ns::f`` -> ``f``)."""
    return short_name(name).rsplit("::", 1)[-1]


class Trace:
    """What one profiled loop of ``frames`` frames shows."""

    def __init__(self, events, frames: int):
        self.frames = frames
        device, cpu = [], []
        self.host_copies = []   # (start, end, operand shapes) of COPY_OPS
        runtime = {}            # correlation id -> start of the runtime call
        window = None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                kind = _kind(e)
                if kind:
                    device.append((e.name(), start, end, kind, e.correlation_id()))
                continue
            if e.name().startswith("cuda"):
                runtime[e.correlation_id()] = start
            if e.name() == WINDOW:
                window = (start, end, e.start_thread_id())
            else:
                cpu.append((start, end, e.name(), e.start_thread_id()))
                if e.name() in COPY_OPS:
                    self.host_copies.append((start, end, _shapes(e)))
        if window is None:
            raise RuntimeError(f"the profile holds no {WINDOW!r} span")
        self.window = window[:2]
        w0, w1 = self.window
        self.device = [DeviceOp(n, s, e, k, runtime.get(c, s))
                       for n, s, e, k, c in device if e > w0 and s < w1]
        self.device.sort(key=lambda d: d.start)
        host = sorted((c for c in cpu if c[3] == window[2] and c[1] > w0 and c[0] < w1),
                      key=lambda c: (c[0], -c[1]))
        self._host_start = [c[0] for c in host]
        self._host = host
        self._parent = self._nesting(host)

    @staticmethod
    def _nesting(host) -> list:
        parent, stack = [], []
        for i, (start, end, _, _) in enumerate(host):
            while stack and host[stack[-1]][1] <= start:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        return parent

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def copies_during(self, shape, direction: str = "dtoh") -> list:
        """Device copies in ``direction`` issued inside a host copy
        operation with an operand of ``shape``."""
        spans = sorted((s, e) for s, e, shapes in self.host_copies
                       if list(shape) in shapes)
        starts = [s for s, _ in spans]
        out = []
        for d in self.device:
            if d.kind != "memcpy" or direction not in d.name.lower().replace(" ", ""):
                continue
            i = bisect.bisect_right(starts, d.issued) - 1
            if i >= 0 and spans[i][1] >= d.issued:
                out.append(d)
        return out

    def busy_intervals(self) -> list:
        """The union of device-busy intervals inside the window."""
        w0, w1 = self.window
        merged = []
        for d in self.device:
            s, e = max(d.start, w0), min(d.end, w1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def host_op_at(self, t: int) -> str:
        """The innermost host operation running at ``t`` on the thread
        that ran the window, or ``python`` between operations."""
        i = bisect.bisect_right(self._host_start, t) - 1
        while i >= 0 and self._host[i][1] < t:
            i = self._parent[i]
        if i < 0:
            return "python"
        name = self._host[i][2]
        return "python (Renderer.step)" if name == FRAME else name

    def idle_gaps(self) -> list:
        """(host operation, idle seconds) summed over the device's idle
        gaps inside the window, each gap named by the host operation
        running at its middle, largest first."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy_intervals() for x in iv] + [w1]
        by_name = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                name = self.host_op_at((s + e) // 2)
                by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> list:
        """(operation, device seconds) by short name, largest first."""
        by_name = {}
        for d in self.device:
            name = short_name(d.name) if d.kind == "kernel" else d.name
            by_name[name] = by_name.get(name, 0.0) + (d.end - d.start) * 1e-9
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def kernel_ms_per_frame(self, match) -> float:
        """Device ms a frame of the kernels whose unqualified function
        name ``match`` accepts."""
        total = sum(d.end - d.start for d in self.device
                    if d.kind == "kernel" and match(function_name(d.name)))
        return total * 1e-6 / self.frames


def breakdown(trace: Trace) -> dict:
    return {"device_ops": [[n, s] for n, s in trace.device_ops()[:10]],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps()[:10]]}
