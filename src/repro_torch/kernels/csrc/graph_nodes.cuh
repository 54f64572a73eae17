// A library's launches inside a captured CUDA graph, read from the graph's
// kernel nodes (kernels/build.py, KernelLibrary.graph_launches).
//
// A graph replays kernels without their wrappers, which count launches; so
// a replay's count comes from what the graph holds. Each source that
// includes this header lists, in a table of GraphEntry, every __global__
// function that one launch of a body runs (one such function a wrapper
// call, counted once), with the body's name; a function that runs beside
// it in the same call (decode attention's merge) is left out. It exports
// the table through graph_entries and the graph's nodes through
// graph_functions. The nodes are read through this library's own CUDA
// runtime, which registered its kernels: cudaGraphKernelNodeGetParams
// gives a node's function as the host address the table holds, and
// refuses a node whose kernel another runtime registered (PyTorch's,
// cuBLAS's, another library's).
#pragma once

#include <cuda_runtime.h>

#include <vector>

namespace graph_nodes {

struct GraphEntry {
  const void* func;
  const char* body;
};

// the table's functions and bodies, up to `max` of each; returns the
// table's length
template <int N>
int entries(const GraphEntry (&table)[N], const void** funcs,
            const char** bodies, int max) {
  for (int i = 0; i < N && i < max; ++i) {
    funcs[i] = table[i].func;
    bodies[i] = table[i].body;
  }
  return N;
}

// the function of every kernel node of `graph` whose kernel this runtime
// registered, in the graph's node order, up to `max` of them; returns
// their number, or minus a cudaError_t
inline int functions(void* graph, const void** funcs, int max) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return -static_cast<int>(e);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (e = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess)
    return -static_cast<int>(e);
  int found = 0;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(node, &type)) != cudaSuccess)
      return -static_cast<int>(e);
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams p = {};
    if (cudaGraphKernelNodeGetParams(node, &p) != cudaSuccess) {
      cudaGetLastError();  // another runtime's kernel: clear the refusal
      continue;
    }
    if (found < max) funcs[found] = p.func;
    ++found;
  }
  return found;
}

}  // namespace graph_nodes
