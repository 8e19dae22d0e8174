// Native policy runtime for robot deployment.
//
// The reference deploys trained policies to the robot's C++ control loop via
// TorchScript export (legged_gym/utils/helpers.py:188-231 +
// PolicyExporterLSTM :204-231). This runtime serves the same purpose without
// a torch dependency: it loads the framework's flat binary policy export
// (.grxpolicy, written by wiki_grx_gym_tpu_torch.deploy.runtime.export_policy_bin,
// byte for byte the JAX package's format) and evaluates the actor deterministically at control rate. Recurrent
// (LSTM) policies carry their hidden state inside the handle, exactly like
// PolicyExporterLSTM keeps hidden/cell buffers inside the exported module.
//
// File format (little endian):
//   magic   uint32 = 0x47525850  ("GRXP")
//   version uint32 = 1 (MLP only) | 2 (LSTM memory + MLP head)
//   n_layers uint32               -- MLP layers
//   act_id   uint32 (0=elu, 1=relu, 2=tanh)
//   [version 2 only]
//     n_lstm  uint32              -- stacked LSTM layers
//     hidden  uint32              -- hidden size H
//     then per LSTM layer: in_dim uint32,
//       W_ih float32[in*4H] (row-major, in x 4H, gate order i,f,g,o),
//       W_hh float32[H*4H], b float32[4H] (= b_ih + b_hh folded)
//   then per MLP layer: in_dim uint32, out_dim uint32,
//                   W float32[in*out] (row-major, in x out), b float32[out]

#pragma once

#include <cstdint>
#include <cstddef>

extern "C" {

typedef struct GrxPolicy GrxPolicy;

// Load a .grxpolicy file; returns NULL on failure.
GrxPolicy* grx_policy_load(const char* path);

// Input / output dimensions.
int grx_policy_input_dim(const GrxPolicy*);
int grx_policy_output_dim(const GrxPolicy*);

// Number of stacked LSTM layers (0 for a pure-MLP policy).
int grx_policy_num_lstm_layers(const GrxPolicy*);

// Evaluate the deterministic policy: obs[input_dim] -> act[output_dim].
// For a recurrent policy this advances the internal hidden state by one
// control step. Returns 0 on success.
int grx_policy_forward(GrxPolicy*, const float* obs, float* act);

// Batched evaluation (n stacked observations). For a recurrent policy the
// rows are treated as consecutive control steps of ONE robot (streaming),
// matching PolicyExporterLSTM's stateful single-robot semantics.
int grx_policy_forward_batch(GrxPolicy*, const float* obs, float* act, int n);

// Zero the recurrent hidden state (PolicyExporterLSTM.reset_memory).
// No-op for pure-MLP policies.
void grx_policy_reset(GrxPolicy*);

void grx_policy_free(GrxPolicy*);

}  // extern "C"
