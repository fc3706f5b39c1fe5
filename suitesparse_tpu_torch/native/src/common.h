// Shared declarations for the suitesparse_tpu_torch host kernels.
//
// All indices are int64 (the reference's SuiteSparse_long discipline —
// nnz(L) of audikw_1-class matrices overflows int32). All entry points are
// extern "C" for ctypes binding; no global state; thread-safe per call.
#pragma once
#include <cstdint>
#include <vector>
#include <algorithm>

using i64 = int64_t;
using u64 = uint64_t;

#define SSTPU_API extern "C" __attribute__((visibility("default")))
