"""Hand-written Hopper kernels of the port, each beside its plain version.

flash_attention.py -- causal/windowed/softcapped GQA attention forward
(CUDA C++ in csrc/flash_attention.cu); slstm_scan.py -- the sLSTM
recurrence over a whole sequence (CUDA C++ in csrc/slstm_scan.cu);
ssm_scan.py -- the Mamba-1 selective scan (CUDA C++ in csrc/ssm_scan.cu);
expert_gemm.py -- the grouped expert GEMM of the MoE block (CUDA C++ in
csrc/expert_gemm.cu); decode_attention.py -- one query a lane against the
serving cache, read in place up to each lane's position (CUDA C++ in
csrc/decode_attention.cu; no TPU kernel: added for the decode step).
build.py compiles and loads them at first use; ops.py dispatches on the
device.
"""
