// Stage marks: one empty kernel per stage of a compiled program.
//
// A host range (torch.profiler.record_function, NVTX) inside a function
// that utils/jit.py captures into a CUDA graph runs once, at the capture,
// and never on a replay. So a stage boundary that a trace of replays can
// see has to be device work inside the graph: utils/profiling.py's
// mark(stage) launches the empty kernel sdvg_mark_<stage> on the current
// stream, the capture records it as a kernel node, and every replay runs
// it on the device's timeline between the stage before and the stage
// after. A stage runs from its mark to the next mark; each program ends
// with sdvg_mark_end. A mark reads and writes nothing, so it changes no
// result; on the card it costs a launch inside the graph (about a
// microsecond of device time).
//
// The kernels keep C linkage, so the trace names them as written here.
// No name contains a word the benchmark's buckets match on (copy, reduce,
// gemm, conv, ...): the marks fall under "other".
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with the other sources;
// called through ctypes (plain C interface below).

#include <cuda_runtime.h>

extern "C" {

#define SDVG_MARK(stage) \
  __global__ void sdvg_mark_##stage() {}

SDVG_MARK(vae)
SDVG_MARK(rollout)
SDVG_MARK(unet)
SDVG_MARK(forward)
SDVG_MARK(backward)
SDVG_MARK(exchange)
SDVG_MARK(optimizer)
SDVG_MARK(end)

#undef SDVG_MARK

// Launches the mark of stage index `stage` (the order of
// utils/profiling.py's STAGES, which is the order above) on `stream`, one
// thread. Returns the cudaError_t of the launch (0 on success).
int sdvg_stage_mark(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: sdvg_mark_vae<<<1, 1, 0, s>>>(); break;
    case 1: sdvg_mark_rollout<<<1, 1, 0, s>>>(); break;
    case 2: sdvg_mark_unet<<<1, 1, 0, s>>>(); break;
    case 3: sdvg_mark_forward<<<1, 1, 0, s>>>(); break;
    case 4: sdvg_mark_backward<<<1, 1, 0, s>>>(); break;
    case 5: sdvg_mark_exchange<<<1, 1, 0, s>>>(); break;
    case 6: sdvg_mark_optimizer<<<1, 1, 0, s>>>(); break;
    case 7: sdvg_mark_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
