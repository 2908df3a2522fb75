"""Device timing on the GPU with CUDA events (used by chip_smoke.py; a CPU
run has no device time to give)."""

import torch


def _elapsed_ms(run, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, iters):
    """Mean time of fn() over `iters` eager calls back to back, as the device
    sees it: host launch gaps between calls count."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    return _elapsed_ms(fn, iters) / iters


def graph_ms(fn, iters=100, reps=20):
    """Device time of one fn() call: `iters` calls captured in one CUDA
    graph, replayed `reps` times, so no host launch gap counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(graph.replay, reps) / (reps * iters)
