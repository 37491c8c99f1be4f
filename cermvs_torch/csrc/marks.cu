// Device marks of the port's tracing spans (cermvs_torch/utils/profiling.py)
// for Hopper (sm_90a).
//
// Replaces no TPU kernel. A span's host range (torch.profiler's
// record_function) is recorded only when the host runs the span's code, so
// a forward or a train step captured in a CUDA graph shows its ranges at
// the capture and never at a replay. A kernel launch is captured like any
// other and runs at every replay, so a span launches an empty kernel of its
// own at entry (cermvs_mark_begin_<id>) and at exit (cermvs_mark_end_<id>)
// on the stream its work is launched on: in a device trace the two bracket
// the span's work at every replay. The kernel's name carries the span's id;
// profiling.MARKS maps ids to span names.
//
// What bounds them: nothing but the launch. Each is one thread that does
// nothing, about a microsecond of device time; a span costs two.
//
// The kernels are extern "C" so that a trace names them without mangling.

#include <cuda_runtime.h>

#define CERMVS_MARK_IDS(X)                                                  \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)  \
  X(26) X(27) X(28) X(29) X(30) X(31)

#define CERMVS_DEFINE_MARKS(id)                           \
  extern "C" __global__ void cermvs_mark_begin_##id() {} \
  extern "C" __global__ void cermvs_mark_end_##id() {}
CERMVS_MARK_IDS(CERMVS_DEFINE_MARKS)

namespace {

#define CERMVS_BEGIN_MARK(id) (const void*)cermvs_mark_begin_##id,
#define CERMVS_END_MARK(id) (const void*)cermvs_mark_end_##id,
const void* const kBegin[] = {CERMVS_MARK_IDS(CERMVS_BEGIN_MARK)};
const void* const kEnd[] = {CERMVS_MARK_IDS(CERMVS_END_MARK)};
constexpr int kMarks = sizeof(kBegin) / sizeof(kBegin[0]);

}  // namespace

extern "C" {

// Launch the begin (end == 0) or end mark of span `id` (0 <= id < 32) on
// `stream`, one thread.
int cermvs_mark(int id, int end, void* stream) {
  if (id < 0 || id >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaLaunchKernel(end ? kEnd[id] : kBegin[id], dim3(1), dim3(1),
                       nullptr, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* marks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
