"""CUDA graph capture, shared by the ECG step graph (``solvers/ecg.py``)
and LORASC's banded solves (``precond/lorasc_scale.py``)."""

import torch


def capture_graph(fn, device):
    """``fn()`` as a CUDA graph on ``device``, PyTorch's recipe: two warm-up
    calls on a side stream (library handles and workspaces are made there),
    then the capture on the same stream into the graph's private pool.
    Returns the graph and what the captured call returned (tensors in the
    pool, which every replay rewrites). A call that cannot be captured (one
    that synchronises) raises RuntimeError, after the capture is ended."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
        graph.capture_begin()
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass            # the invalidated capture's own error
            raise
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph, out
