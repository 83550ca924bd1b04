"""The kernels that a captured CUDA graph launches on each replay.

``kernel_nodes(graph)`` walks a ``torch.cuda.CUDAGraph`` captured with
``keep_graph=True`` through the CUDA driver API (``cuGraphGetNodes``,
``cuGraphKernelNodeGetParams``, ``cuFuncGetName``) and counts its kernel
nodes by their (mangled) function name.  A replay launches every kernel
node once, so these are the launches of one replay as the graph holds
them, not as the wrappers counted them while it was captured.  The
CUDA driver's library is opened only when the function is called.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict

_KERNEL = 0        # CU_GRAPH_NODE_TYPE_KERNEL
_CHILD_GRAPH = 4   # CU_GRAPH_NODE_TYPE_GRAPH


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (the v1 struct is its prefix)."""

    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _driver():
    """libcuda with the argument types of the entry points used here."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, name = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    for fn, args in ((cu.cuGraphGetNodes,
                      [ptr, ptr, ctypes.POINTER(ctypes.c_size_t)]),
                     (cu.cuGraphNodeGetType,
                      [ptr, ctypes.POINTER(ctypes.c_int)]),
                     (get_params, [ptr, ctypes.POINTER(_KernelNodeParams)]),
                     (cu.cuGraphChildGraphNodeGetGraph,
                      [ptr, ctypes.POINTER(ptr)]),
                     (cu.cuFuncGetName, [name, ptr]),
                     (cu.cuKernelGetName, [name, ptr])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return cu, get_params


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed (CUresult {err})")


def _count(cu, get_params, graph: int, out: collections.Counter,
           names: dict) -> None:
    """Adds the kernel nodes of ``graph`` (a CUgraph), and of its child
    graphs, to ``out`` by function name (``names``: the names of the
    functions already met)."""
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    kind = ctypes.c_int()
    params = _KernelNodeParams()
    fname = ctypes.c_char_p()
    for node in nodes:
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == _CHILD_GRAPH:
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
            _count(cu, get_params, child.value, out, names)
            continue
        if kind.value != _KERNEL:
            continue
        params.func = params.kern = None
        _check(get_params(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        key = (params.func, params.kern)
        if key not in names:
            if params.func:
                _check(cu.cuFuncGetName(ctypes.byref(fname), params.func),
                       "cuFuncGetName")
            else:
                _check(cu.cuKernelGetName(ctypes.byref(fname), params.kern),
                       "cuKernelGetName")
            names[key] = fname.value.decode()
        out[names[key]] += 1


def kernel_nodes(graph) -> Dict[str, int]:
    """The kernel nodes of ``graph`` (a ``torch.cuda.CUDAGraph`` captured
    with ``keep_graph=True``), counted by mangled function name."""
    cu, get_params = _driver()
    out = collections.Counter()
    _count(cu, get_params, graph.raw_cuda_graph(), out, {})
    return dict(out)
