// The MoE build of the decode megakernel: csrc/megakernel.cu compiled with
// TDT_MEGA_MOE, so that its library holds only the kMoE instantiations of
// mega_kernel and exports tdt_mega_decode and tdt_mega_decode_tp for MoE
// launches only (at tp=1, and over n > 1 co-located ranks with the experts
// expert-parallel). A separate library keeps the dense library's
// instantiations unchanged and builds in parallel with it.
//
// Replaces: the MoE bodies of the megakernel pallas_call,
// triton_distributed_tpu/megakernel/kernels.py:1133 moe_gate_body (what
// triton_distributed_tpu/ops/moe/routing.py router_topk computes), :1188
// moe_ffn_body (one expert's SwiGLU FFN of the grouped expert GEMMs,
// triton_distributed_tpu/ops/moe/grouped_gemm.py, weighted into the
// combine), :1254 a2a_send_body and :1297 a2a_wait_body (at tp=1 without a
// peer; at tp > 1 with the puts and waits of :442 _a2a_put_dmas and :469
// _a2a_wait_recvs).
//
// What bounds it on the H100: bytes, as the dense decode step (see
// megakernel.cu), with the weights of the experts the step's rows route
// to in place of the dense MLP: an expert no row routes to is skipped.
#define TDT_MEGA_MOE 1
#include "megakernel.cu"
