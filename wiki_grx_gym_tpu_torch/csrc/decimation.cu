// K1: the decimation kernel, one whole policy step per env, for Hopper (sm_90a).
//
// Replaces wiki_grx_gym_tpu/sim/pallas_step.py:PallasDecimation._kernel (the
// Pallas TPU kernel over sim/scalarized.py:ScalarDecimation.run and
// envs/post_lanes.py:LanePost.run). Per env it runs: the actuation-delay gate,
// PD torques, `decimation` physics substeps (FK over the static tree, ground
// contact with anchored stick friction, sphere-sphere self-collision, CRBA
// mass matrix + RNEA bias, an unrolled (6+D)^2 Cholesky solve, semi-implicit
// Euler), the feet accumulators, the final-state FK of the post bodies, and
// in the post-fold program the post-physics stage (every lane-form reward
// term of envs/post_lanes.py, one __device__ function a term selected by the
// program's reward ids; the penalized-contact count; termination, tilt, bad,
// contact filter, air/land trackers).
//
// Control laws (K1_CTRL; sim/scalarized.py:CONTROL_TYPES): 0, P (joint
// position targets); 1, V (velocity targets, damped by the change of joint
// velocity since the previous policy step over the sim dt: it reads the
// last_qd input); 2, T (torques). The launch setup gives V the implicit
// damping p + d / sim_dt and T none (has_damp 0).
//
// Terrain modes (K1_TERRAIN; sim/scalarized.py:ScalarSubstep terrain_mode):
// 0, the flat plane at ground_h; 1, "local_plane": each contact point reads
// its own ground plane h = c + gx x + gy y (3 input lanes a point, sampled
// from the heightfield by the env once a policy step), with the normal-aware
// penalty and the anchored friction projected on the plane; 2,
// "local_plane_walls" (trimesh): 9 lanes a point, the tread plane and up to
// one riser face per axis, a frictionless wall penalty, and no tread force
// for a center inside a riser solid. Both terrain modes also write the
// final-state world position of every contact point (where the env samples
// the next step's planes). The post fold (K1_FOLD) is off on terrain and
// with heading commands: the env then runs the post stage itself
// (envs/legged_env.py), and K1 neither reads its inputs nor writes its
// outputs.
//
// One library is built per program (struct Sizes: bodies, dofs, contact
// points, pairs, reward terms, input and output widths, terrain mode, fold,
// control law, penalized contact groups and their points) and team shape, from -D flags (sim/cuda_step.py:nvcc_flags); the GR1T1
// and GR1T2 lower limbs share one size set, the 32-DOF full bodies another,
// a config with self-collision off (no pairs) a third, each terrain mode
// and the heading commands' non-fold plane program one each, and so do the
// fold with all 50 terms and penalized groups and each control law.
//
// Two kernels compute it. decimation_team_kernel is the main path's:
//
// - Lane mapping. One env runs on a team of T lanes of one warp (the only
//   barrier is __syncwarp on the team's lanes), E envs a block: 16 x 8 for
//   the 10-DOF lower limb, 32 x 8 for the 32-DOF body (sim/cuda_step.py:
//   team_shape; PERF.md records the shapes measured). Lane l takes dofs l,
//   l + T, ... (torques, joint limits, the joint update), contact points and
//   self-collision pairs l, l + T, ..., bodies l, l + T, ... (the contact
//   wrench over its points, world inertia, gravity wrench, body force),
//   row l of the (6+D)^2 mass matrix, which it keeps in registers through
//   the Cholesky (the rows past T, the full body's 6, one column a lane;
//   other lanes' entries by shuffle), and reward terms l, l + T, .... FK
//   and the bias recursion go down the tree level by level or one
//   component a lane, the sums to the root one component a lane; the back
//   substitution, the base's integration and the post stage's scalars run
//   on lane 0.
// - Shared memory. Each block copies the model constants (5.4 KB for the
//   lower limb, 13 KB for the full body) into shared memory once, since
//   lanes read them at different indices, and stages its envs' inputs and
//   outputs there so that device memory is read and written one component
//   row at a time. An env's working set (TeamEnv: the state, FK, contact and
//   the composite dynamics, the phases' short-lived arrays in one union) is
//   5.3 KB for the lower limb, padded to 16 (mod 32) words so that the two
//   teams of a warp read a field 16 banks apart (8 envs and the constants:
//   48 KB, 4 blocks or 16 warps an SM, the main path's 4096 envs in one
//   wave), and 11.2 KB for the full body, whose Cholesky factor shares the
//   union with the dynamics arrays (team_shared_ls; 14.2 KB apart): 8 envs
//   and the constants take 103 KB, 2 blocks or 16 warps an SM.
//   The launch bounds ask for the blocks that warps and shared memory allow
//   (team_min_blocks), which sets the registers a thread may take: 128 for
//   both.
// - What bounds it: one env's chain of dependent steps, not FP32 throughput
//   or bytes. 4096 envs fill at most 16 warps an SM, so little latency is
//   hidden; the tree (5 levels for the lower limb), the 6 + D Cholesky
//   columns (a square root and two true divisions each), the serial back
//   substitution and the sums kept in serial order are sequential in each
//   of the 10 substeps. scripts/profile_k1.py times it phase by phase.
// - Barriers: tests/test_torch_decimation_race.py compiles the kernels for
//   the CPU (csrc/host/, K1_KERNELS_ONLY) and runs them under
//   ThreadSanitizer, which finds any shared-memory access pair that no
//   __syncwarp or __syncthreads orders.
//
// decimation_kernel runs one thread per env (model constants in
// __constant__ memory, every intermediate in the thread: 255 registers and
// spills). It stays as the team kernel's reference: the team kernel
// computes every output with the same float operations in the same order
// and association (the serial sums keep their order through lists the
// wrapper builds: per point its pairs, per body its points, the ancestors of
// each dof), so the two agree bit for bit in every output lane
// (chip_smoke.py phase 3, tests/test_torch_decimation_cuda.py). Only checks
// and timings launch it.
//
// Numerics: the statements follow the plain lane program in the same order
// and association. Model constants that the lane program folds in float64 on
// the host (d_t, d_ns, imp_cap, the composite subtree masses, the gravity
// terms, the joint-limit gains) arrive folded the same way. max/min/clip
// propagate NaN like torch.maximum/torch.clamp (CUDA's fmaxf/fminf do not),
// so an exploded env stays NaN and its `bad` flag fires. jnp.where selects
// are ternaries on values that are both computed.
//
// Interface (plain C, loaded with ctypes): k1_const_size, k1_set_constants,
// k1_copy_constants (from a device copy; the form a CUDA graph captures),
// k1_launch (the team kernel), k1_launch_thread (the one-thread kernel),
// k1_occupancy (the team kernel's shape, shared memory and blocks per SM).
// One team shape (TEAM_T x TEAM_E) is instantiated per library. A launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

// The model's sizes and the team kernel's shape come from the build, one
// library per distinct set (sim/cuda_step.py:nvcc_flags passes them as -D
// flags, and build.library_path names the library by its flags).
#if !defined(K1_NB) || !defined(K1_ND) || !defined(K1_NP) || !defined(K1_NF) || !defined(K1_NPAIR) || \
    !defined(K1_NR) || !defined(K1_NPOST) || !defined(K1_NIN) || !defined(K1_NOUT) ||                 \
    !defined(K1_TERRAIN) || !defined(K1_FOLD) || !defined(K1_CTRL) || !defined(K1_NPEN) ||            \
    !defined(K1_NPENP) || !defined(K1_TEAM_T) || !defined(K1_TEAM_E)
#error "K1 is built for one program: define K1_NB ... K1_NOUT, K1_TERRAIN, K1_FOLD, K1_CTRL, K1_NPEN, K1_NPENP, K1_TEAM_T and K1_TEAM_E"
#endif

// Every name of the device code has internal linkage (the unnamed namespace):
// a process may load one library per size set, and two size sets must share
// no symbol, neither the constants nor a kernel or a static of a template
// (`Sizes` has one name whatever its sizes).
namespace k1 {
namespace {

struct Sizes {
  static constexpr int NB = K1_NB;        // bodies
  static constexpr int ND = K1_ND;        // dofs
  static constexpr int NP = K1_NP;        // contact points
  static constexpr int NF = K1_NF;        // feet
  static constexpr int NPAIR = K1_NPAIR;  // self-collision pairs (0: self-collision off)
  static constexpr int NR = K1_NR;        // reward terms
  static constexpr int NPOST = K1_NPOST;  // post-FK bodies
  static constexpr int NIN = K1_NIN;      // input components (sim/cuda_step.py:_schema)
  static constexpr int NOUT = K1_NOUT;    // output components
  static constexpr int NPEN = K1_NPEN;    // penalized contact groups (post fold)
  static constexpr int NPENP = K1_NPENP;  // their points in all
};
static_assert(Sizes::ND >= 1 && Sizes::ND <= 32, "anc_mask holds one bit a dof in 32 bits");

// the program: terrain mode (0 plane, 1 local_plane, 2 local_plane_walls),
// whether the post stage is folded in, and the control law (0 P, 1 V, 2 T)
constexpr int TERRAIN = K1_TERRAIN;
constexpr bool FOLD = K1_FOLD != 0;
constexpr int CTRL = K1_CTRL;
static_assert(TERRAIN >= 0 && TERRAIN <= 2, "K1_TERRAIN is 0, 1 or 2");
static_assert(CTRL >= 0 && CTRL <= 2, "K1_CTRL is 0 (P), 1 (V) or 2 (T)");
// the last_qd input: V's damping term and the post stage's joint accelerations
constexpr bool WITH_LAST_QD = CTRL == 1 || FOLD;
constexpr int PLANE_LANES = TERRAIN == 0 ? 0 : TERRAIN == 1 ? 3 : 9;  // ground lanes a point

// an array's capacity for a count that may be 0 (no zero-length arrays;
// the loops run to the count)
__host__ __device__ constexpr int cap(int n) { return n > 0 ? n : 1; }

constexpr int MAXG = 8;       // termination-group capacity
constexpr int N_IN_GROUPS = 22;
constexpr int N_OUT_GROUPS = 29;
constexpr int THREADS = 64;   // the one-thread kernel's block
// The team kernel's shape: lanes per env and envs per block
// (sim/cuda_step.py:team_shape; PERF.md records the shapes tried).
constexpr int TEAM_T = K1_TEAM_T, TEAM_E = K1_TEAM_E;
static_assert(TEAM_T == 8 || TEAM_T == 16 || TEAM_T == 32, "a team is a power-of-two part of a warp");
static_assert(TEAM_E >= 1 && TEAM_T * TEAM_E % 32 == 0 && TEAM_T * TEAM_E <= 512, "whole warps a block");

enum InGroup {
  IN_POS, IN_QUAT, IN_LIN, IN_ANG, IN_Q, IN_QD, IN_ANCHOR, IN_ACTIONS, IN_LAST_ACTIONS,
  IN_MOTOR, IN_DELAY, IN_FRICTION, IN_RESTITUTION, IN_MASS_SCALE, IN_COM_OFFSET,
  IN_LAST_QD, IN_COMMANDS, IN_LAST_LAST_ACTIONS, IN_FEET_AIR_TIME, IN_FEET_LAND_TIME,
  IN_FEET_CONTACT_LAST, IN_PLANE
};
enum OutGroup {
  OUT_POS, OUT_QUAT, OUT_LIN, OUT_ANG, OUT_Q, OUT_QD, OUT_ANCHOR, OUT_FORCE_SUM,
  OUT_VXYZ_SUM, OUT_VRPY_SUM, OUT_TAU, OUT_POINT_FORCE, OUT_POST_QUAT, OUT_POST_REL,
  OUT_REW_TERMS, OUT_BLV, OUT_BAV, OUT_PG, OUT_TERM_CONTACT, OUT_TILT, OUT_BAD,
  OUT_FEET_CONTACT, OUT_CONTACT_FILT, OUT_FIRST_CONTACT, OUT_FEET_AIR_TIME,
  OUT_FEET_LAND_TIME, OUT_FEET_HEIGHT, OUT_BHO, OUT_POINT_POS
};
// reward term ids (sim/cuda_step.py:REWARD_IDS, the terms' names in
// alphabetical order)
enum Reward {
  RW_ACTION_DIFF, RW_ACTION_DIFF_DIFF, RW_ACTION_DIFF_KNEE, RW_ACTION_RATE,
  RW_ANG_VEL_XY, RW_BASE_HEIGHT, RW_CMD_ANG_VEL_PITCH, RW_CMD_ANG_VEL_ROLL,
  RW_CMD_ANG_VEL_YAW, RW_CMD_BASE_HEIGHT, RW_CMD_BASE_ORIENT, RW_CMD_FOREHEAD_ORIENT,
  RW_CMD_LIN_VEL_X, RW_CMD_LIN_VEL_Y, RW_CMD_LIN_VEL_Z, RW_CMD_TORSO_ORIENT,
  RW_COLLISION, RW_DOF_ACC, RW_DOF_ACC_NEW, RW_DOF_POS_LIMITS,
  RW_DOF_TOR_ANKLE_LIFT, RW_DOF_TOR_NEW, RW_DOF_TOR_NEW_HIP_ROLL, RW_DOF_VEL,
  RW_DOF_VEL_LIMITS, RW_DOF_VEL_NEW, RW_DOF_VEL_NEW_KNEE, RW_FEET_AIR_FORCE,
  RW_FEET_AIR_HEIGHT, RW_FEET_AIR_TIME, RW_FEET_CONTACT_FORCES, RW_FEET_LAND_TIME,
  RW_FEET_SPEED_XY, RW_FEET_SPEED_Z, RW_FEET_STUMBLE, RW_LIMITS_ACTIONS,
  RW_LIMITS_DOF_POS, RW_LIMITS_DOF_TOR, RW_LIMITS_DOF_VEL, RW_LIN_VEL_Z,
  RW_ON_THE_AIR, RW_ORIENTATION, RW_POSE_OFFSET, RW_POSE_OFFSET_HIP_YAW,
  RW_STAND_STILL, RW_STUMBLE, RW_TORQUE_LIMITS, RW_TORQUES,
  RW_TRACKING_ANG_VEL, RW_TRACKING_LIN_VEL
};

// Field order and sizes mirror sim/cuda_step.py:_ModelConst.
template <class S>
struct ModelConst {
  int parent[S::NB];
  int point_body[S::NP];
  int pair_i[cap(S::NPAIR)], pair_j[cap(S::NPAIR)];
  int feet_body[S::NF];
  int feet_start[S::NF], feet_count[S::NF];
  int feet_pts[S::NP];
  int post_body[S::NPOST];
  int feet_slot[S::NF];
  int n_term, term_start[MAXG], term_count[MAXG];
  int term_pts[S::NP];
  int torso_slot, forehead_slot;
  int n_ankle_left, ankle_left[S::ND];
  int n_ankle_right, ankle_right[S::ND];
  int n_knee, knee[S::ND], n_hip_roll, hip_roll[S::ND], n_hip_yaw, hip_yaw[S::ND];
  int pen_start[cap(S::NPEN)], pen_count[cap(S::NPEN)], pen_pts[cap(S::NPENP)];
  int reward_id[cap(S::NR)];
  int decimation, use_tangent, use_joint_limits, has_damp;
  int in_off[N_IN_GROUPS], out_off[N_OUT_GROUPS];
  // the team kernel's schedule (built by the wrapper, sim/cuda_step.py:team_lists)
  int pt_pair_start[S::NP + 1], pt_pair[cap(2 * S::NPAIR)];  // per point: 2 s + (1 if it is pair s's j)
  int body_pt_start[S::NB + 1], body_pts[S::NP];             // per body: its points, ascending
  int n_levels, level_start[S::NB], level_body[S::NB];       // bodies >= 1 by depth in the tree
  unsigned anc_mask[S::ND];  // bit j of row i: dof j is an ancestor-or-self of dof i
  float tree_pos[S::NB][3], tree_quat[S::NB][4], axis_unit[S::NB][3], axis[S::NB][3];
  float mass[S::NB], com[S::NB][3], inertia[S::NB][3][3];
  float grav_z[S::NB], cm_sub[S::NB];
  float armature[S::ND];
  float dof_lower[S::ND], dof_upper[S::ND], lim_k[S::ND], lim_damp[S::ND];
  float point_offset[S::NP][3], point_radius[S::NP];
  float pair_rsum[cap(S::NPAIR)];
  float dt, stiffness, damping_ratio, sqrt_kpm, imp_cap, kt, d_t, k_self, d_ns,
      slip_velocity, grav, gscale, ground_h;
  float action_scale, p_gain[S::ND], d_gain[S::ND], default_q[S::ND],
      torque_limit[S::ND], damp_coeff[S::ND];
  float dt_policy, decimation_f, hscale, target_h;
  float feet_offset[S::NF][3];
  float torso_qoff[4], forehead_qoff[4];
  float soft_lo[S::ND], soft_hi[S::ND], vel_soft[S::ND], tor_soft[S::ND];
  float scale[cap(S::NR)], sigma[cap(S::NR)];
  float swing_target, swing_half, swing_quarter, fat_target, fat_half, flt_max,
      stumble_ratio, swing_3q, tracking_sigma, max_contact_force;
};

using Sz = Sizes;
__constant__ ModelConst<Sz> c_model;
__device__ ModelConst<Sz> g_model;  // the same bytes; each team-kernel block copies it to shared memory

// ---------------------------------------------------------------------------
// lane algebra, NaN-propagating like torch.maximum / torch.clamp
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? b : a);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (b < a ? b : a);
}
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}
__device__ __forceinline__ float b2f(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  float ax = a[0], ay = a[1], az = a[2], aw = a[3];
  float bx = b[0], by = b[1], bz = b[2], bw = b[3];
  o[0] = aw * bx + ax * bw + ay * bz - az * by;
  o[1] = aw * by - ax * bz + ay * bw + az * bx;
  o[2] = aw * bz + ax * by - ay * bx + az * bw;
  o[3] = aw * bw - ax * bx - ay * by - az * bz;
}
// maths.quat_apply: (v + t*w) + q_xyz x t, t = 2 (q_xyz x v)
__device__ __forceinline__ void qapply(const float* q, const float* v, float* o) {
  float c[3], t[3], c2[3];
  cross3(q, v, c);
  t[0] = c[0] * 2.0f; t[1] = c[1] * 2.0f; t[2] = c[2] * 2.0f;
  cross3(q, t, c2);
  o[0] = (v[0] + t[0] * q[3]) + c2[0];
  o[1] = (v[1] + t[1] * q[3]) + c2[1];
  o[2] = (v[2] + t[2] * q[3]) + c2[2];
}
__device__ __forceinline__ void qrotinv(const float* q, const float* v, float* o) {
  float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  qapply(qc, v, o);
}
__device__ __forceinline__ void q_from_angle_axis(float angle, const float* axis, float* o) {
  float half = 0.5f * angle;
  float s = sinf(half);
  o[0] = axis[0] * s; o[1] = axis[1] * s; o[2] = axis[2] * s; o[3] = cosf(half);
}
__device__ __forceinline__ void m3vec(const float m[3][3], const float* v, float* o) {
  for (int r = 0; r < 3; ++r) o[r] = m[r][0] * v[0] + m[r][1] * v[1] + m[r][2] * v[2];
}

// ---------------------------------------------------------------------------
// ground contact of one point (ScalarSubstep.contact_forces, the terrain
// mode's branch; both kernels call it): its force `fo` and new anchor `na`
// from its world position and velocity, radius r, anchor `a`, friction mu,
// normal damping d_n and, in the terrain modes, its ground lanes `pl`
// (c, gx, gy; walls: x pos, top, sign, y pos, top, sign).
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ void point_contact(const ModelConst<S>& K, float r, const float* pos,
                                              const float* vel, const float* a, const float* pl,
                                              float mu, float d_n, float* fo, float* na) {
  if constexpr (TERRAIN == 0) {
    const float depth = nmin(K.ground_h - (pos[2] - r), 0.5f);
    const bool active = depth > 0.0f;
    float f_n = nmax(K.stiffness * depth - d_n * vel[2], 0.0f);
    f_n = active ? f_n : 0.0f;
    const float cone = mu * f_n;
    float ftx, fty;
    if (K.use_tangent) {
      const float kt = K.kt;
      float ex = clipf(pos[0] - a[0], -0.1f, 0.1f);
      float ey = clipf(pos[1] - a[1], -0.1f, 0.1f);
      ftx = -kt * ex - K.d_t * vel[0];
      fty = -kt * ey - K.d_t * vel[1];
      float mag = sqrtf(ftx * ftx + fty * fty);
      float sc = nmin(cone / nmax(mag, 1e-9f), 1.0f);
      ftx = ftx * sc;
      fty = fty * sc;
      na[0] = active ? pos[0] + ftx / kt : pos[0];
      na[1] = active ? pos[1] + fty / kt : pos[1];
      na[2] = pos[2] + 0.0f;
      ftx = active ? ftx : 0.0f;
      fty = active ? fty : 0.0f;
    } else {
      float speed_t = sqrtf(vel[0] * vel[0] + vel[1] * vel[1]);
      float k_t = nmin(cone / nmax(speed_t, K.slip_velocity), K.imp_cap);
      ftx = -k_t * vel[0];
      fty = -k_t * vel[1];
      for (int k = 0; k < 3; ++k) na[k] = a[k];
    }
    fo[0] = ftx; fo[1] = fty; fo[2] = f_n;
  } else {
    // the point's own ground plane, its unit normal n = (-gx, -gy, 1) / |.|
    const float inv = 1.0f / sqrtf(pl[1] * pl[1] + pl[2] * pl[2] + 1.0f);
    const float nrm[3] = {-pl[1] * inv, -pl[2] * inv, inv};
    const float h = pl[0] + pl[1] * pos[0] + pl[2] * pos[1];
    const float depth = nmin(h - (pos[2] - r), 0.5f);
    const bool active = depth > 0.0f;
    const float v_n = dot3(vel, nrm);
    float f_n = nmax(K.stiffness * depth - d_n * v_n, 0.0f);
    f_n = active ? f_n : 0.0f;
    float wall_fx[2] = {0.0f, 0.0f};
    if constexpr (TERRAIN == 2) {
      // a frictionless riser face per axis; no tread force for a center
      // inside a riser solid below its top
      for (int ax = 0; ax < 2; ++ax) {
        const float wp = pl[3 + 3 * ax], wt = pl[4 + 3 * ax], ws = pl[5 + 3 * ax];
        const bool below = pos[2] < wt;
        const float pen = ws * (pos[ax] - wp) + r;
        const bool act_w = (ws != 0.0f) & (pen > 0.0f) & below;
        const float v_nw = -ws * vel[ax];  // outward-normal velocity
        const float f_w = nmax(K.stiffness * nmin(pen, 0.5f) - d_n * v_nw, 0.0f);
        wall_fx[ax] = -ws * (act_w ? f_w : 0.0f);
        const bool inside = (ws != 0.0f) & (ws * (pos[ax] - wp) > 0.0f) & below;
        f_n = inside ? 0.0f : f_n;
      }
    }
    const float cone = mu * f_n;
    float v_t[3], ft[3];
    for (int k = 0; k < 3; ++k) v_t[k] = vel[k] - nrm[k] * v_n;
    if (K.use_tangent) {
      const float kt = K.kt;
      float err[3];
      for (int k = 0; k < 3; ++k) err[k] = clipf(pos[k] - a[k], -0.1f, 0.1f);
      const float en = dot3(err, nrm);
      for (int k = 0; k < 3; ++k) err[k] = err[k] - nrm[k] * en;
      for (int k = 0; k < 3; ++k) ft[k] = -kt * err[k] - K.d_t * v_t[k];
      const float mag = sqrtf(dot3(ft, ft));
      const float sc = nmin(cone / nmax(mag, 1e-9f), 1.0f);
      for (int k = 0; k < 3; ++k) ft[k] = ft[k] * sc;
      for (int k = 0; k < 3; ++k) na[k] = active ? pos[k] + ft[k] / kt : pos[k];
      for (int k = 0; k < 3; ++k) ft[k] = active ? ft[k] : 0.0f;
    } else {
      const float speed_t = sqrtf(dot3(v_t, v_t));
      const float k_t = nmin(cone / nmax(speed_t, K.slip_velocity), K.imp_cap);
      for (int k = 0; k < 3; ++k) ft[k] = v_t[k] * -k_t;
      for (int k = 0; k < 3; ++k) na[k] = a[k];
    }
    for (int k = 0; k < 3; ++k) fo[k] = nrm[k] * f_n + ft[k];
    if constexpr (TERRAIN == 2) {
      fo[0] = fo[0] + wall_fx[0];
      fo[1] = fo[1] + wall_fx[1];
    }
  }
}

// ---------------------------------------------------------------------------
// forward kinematics (ScalarSubstep.fk)
// ---------------------------------------------------------------------------

template <class S>
__device__ void fk(const float* quat0, const float* ang, const float* lin, const float* q,
                   const float* qd, float quats[][4], float pos_rel[][3], float sub[][6],
                   float tw[][6]) {
  const ModelConst<S>& K = c_model;
  for (int k = 0; k < 4; ++k) quats[0][k] = quat0[k];
  for (int k = 0; k < 3; ++k) { pos_rel[0][k] = 0.0f; tw[0][k] = ang[k]; tw[0][3 + k] = lin[k]; }
  for (int k = 0; k < 6; ++k) sub[0][k] = 0.0f;
#pragma unroll 1
  for (int i = 1; i < S::NB; ++i) {
    const int p = K.parent[i];
    float q_static[4], q_joint[4], v[3], a_w[3], c[3];
    qmul(quats[p], K.tree_quat[i], q_static);
    q_from_angle_axis(q[i - 1], K.axis_unit[i], q_joint);
    qmul(q_static, q_joint, quats[i]);
    qapply(quats[p], K.tree_pos[i], v);
    for (int k = 0; k < 3; ++k) pos_rel[i][k] = pos_rel[p][k] + v[k];
    qapply(quats[i], K.axis[i], a_w);
    cross3(pos_rel[i], a_w, c);
    for (int k = 0; k < 3; ++k) { sub[i][k] = a_w[k]; sub[i][3 + k] = c[k]; }
    const float qdi = qd[i - 1];
    for (int k = 0; k < 6; ++k) tw[i][k] = tw[p][k] + sub[i][k] * qdi;
  }
}

// per-env state lanes
template <class S>
struct State {
  float pos[3], quat[4], lin[3], ang[3], q[S::ND], qd[S::ND], anchor[S::NP][3];
};

// ---------------------------------------------------------------------------
// one substep (ScalarSubstep.substep: limits -> fk -> contact -> dynamics ->
// integrate). Leaves the pre-step kinematics and the point forces in the
// caller's arrays for the feet accumulators.
// ---------------------------------------------------------------------------

template <class S>
__device__ void substep(State<S>& st, const float* tau_in, const float* damp_in,
                        float friction, float restitution, float mass_scale,
                        const float* com_offset, const float* plane, float quats[][4],
                        float pos_rel[][3], float sub[][6], float tw[][6], float forces[][3]) {
  const ModelConst<S>& K = c_model;
  constexpr int NB = S::NB, ND = S::ND, NP = S::NP, N6 = 6 + S::ND;
  const float dt = K.dt;
  float tau[ND], damp[ND];
  for (int i = 0; i < ND; ++i) { tau[i] = tau_in[i]; damp[i] = damp_in[i]; }

  // joint position limits
  if (K.use_joint_limits) {
    for (int i = 0; i < ND; ++i) {
      float over = nmax(st.q[i] - K.dof_upper[i], 0.0f);
      float under = nmax(K.dof_lower[i] - st.q[i], 0.0f);
      float viol = b2f((over > 0.0f) | (under > 0.0f));
      float lim_damp = K.lim_damp[i] * viol;
      tau[i] = tau[i] + K.lim_k[i] * (under - over) - lim_damp * st.qd[i];
      damp[i] = damp[i] + lim_damp;
    }
  }

  fk<S>(st.quat, st.ang, st.lin, st.q, st.qd, quats, pos_rel, sub, tw);

  // ---- ground contact ----
  float pts_pos[NP][3], pts_vel[NP][3], new_anchor[NP][3];
  const float mu = friction;
  const float zeta = K.damping_ratio * clipf(1.0f - restitution, 0.05f, 1.0f);
  const float d_n = nmin(2.0f * zeta * K.sqrt_kpm, K.imp_cap);
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    const int b = K.point_body[p];
    float v[3], rel[3], c[3], vel[3], pos[3];
    qapply(quats[b], K.point_offset[p], v);
    for (int k = 0; k < 3; ++k) rel[k] = pos_rel[b][k] + v[k];
    cross3(&tw[b][0], rel, c);
    for (int k = 0; k < 3; ++k) {
      vel[k] = tw[b][3 + k] + c[k];
      pos[k] = st.pos[k] + rel[k];
      pts_pos[p][k] = pos[k];
      pts_vel[p][k] = vel[k];
    }
    point_contact<S>(K, K.point_radius[p], pos, vel, st.anchor[p], plane + PLANE_LANES * p, mu, d_n,
                     forces[p], new_anchor[p]);
  }

  // ---- sphere-sphere self-collision ----
#pragma unroll 1
  for (int s = 0; s < S::NPAIR; ++s) {
    const int i = K.pair_i[s], j = K.pair_j[s];
    float d[3], n[3], rel_v[3];
    for (int k = 0; k < 3; ++k) d[k] = pts_pos[i][k] - pts_pos[j][k];
    float dist = sqrtf(nmax(dot3(d, d), 0.0f));
    float inv = 1.0f / nmax(dist, 1e-6f);
    for (int k = 0; k < 3; ++k) n[k] = d[k] * inv;
    float pen = K.pair_rsum[s] - dist;
    bool active = pen > 0.0f;
    for (int k = 0; k < 3; ++k) rel_v[k] = pts_vel[i][k] - pts_vel[j][k];
    float v_n = dot3(rel_v, n);
    float f_mag = nmax(K.k_self * nmin(pen, 0.1f) - K.d_ns * v_n, 0.0f);
    f_mag = active ? f_mag : 0.0f;
    for (int k = 0; k < 3; ++k) {
      forces[i][k] = forces[i][k] + n[k] * f_mag;
      forces[j][k] = forces[j][k] - n[k] * f_mag;
    }
  }

  // ---- per-body external wrenches at the base origin ----
  float ext_ang[NB][3], ext_lin[NB][3];
  for (int b = 0; b < NB; ++b)
    for (int k = 0; k < 3; ++k) { ext_ang[b][k] = 0.0f; ext_lin[b][k] = 0.0f; }
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    const int b = K.point_body[p];
    float rel[3], c[3];
    for (int k = 0; k < 3; ++k) rel[k] = pts_pos[p][k] - st.pos[k];
    cross3(rel, forces[p], c);
    for (int k = 0; k < 3; ++k) {
      ext_ang[b][k] = ext_ang[b][k] + c[k];
      ext_lin[b][k] = ext_lin[b][k] + forces[p][k];
    }
  }

  // ---- dynamics (ScalarSubstep.dynamics) ----
  float mass[NB], h[NB][3], io[NB][3][3], com_rel[NB][3];
  for (int b = 0; b < NB; ++b) mass[b] = K.mass[b];
  mass[0] = K.mass[0] * mass_scale;
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    const float* qb = quats[b];
    float qx = qb[0], qy = qb[1], qz = qb[2], qw = qb[3];
    float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    float r[3][3] = {
        {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy)},
        {2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx)},
        {2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)}};
    float cl[3], v[3];
    for (int k = 0; k < 3; ++k) cl[k] = (b == 0) ? K.com[0][k] + com_offset[k] : K.com[b][k];
    qapply(qb, cl, v);
    float* cr = com_rel[b];
    for (int k = 0; k < 3; ++k) cr[k] = pos_rel[b][k] + v[k];
    // R I R^T with I constant (_m3_sandwich_const)
    float bm[3][3], iw[3][3];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        bm[a][c] = r[a][0] * K.inertia[b][0][c] + r[a][1] * K.inertia[b][1][c] +
                   r[a][2] * K.inertia[b][2][c];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        iw[a][c] = bm[a][0] * r[c][0] + bm[a][1] * r[c][1] + bm[a][2] * r[c][2];
    const float c2 = dot3(cr, cr);
    const float m = mass[b];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        io[b][a][c] = iw[a][c] + m * ((a == c ? c2 : 0.0f) - cr[a] * cr[c]);
    for (int k = 0; k < 3; ++k) h[b][k] = cr[k] * m;
  }

  // gravity as an external force at each com
  float e_ang[NB][3], e_lin[NB][3];
  for (int b = 0; b < NB; ++b) {
    float gz = (b == 0) ? mass[0] * K.grav * K.gscale : K.grav_z[b];
    float gl[3] = {0.0f, 0.0f, gz};
    float c[3];
    cross3(com_rel[b], gl, c);
    for (int k = 0; k < 3; ++k) {
      e_ang[b][k] = c[k] + ext_ang[b][k];
      e_lin[b][k] = gl[k] + ext_lin[b][k];
    }
  }

  // bias accelerations
  float bias[NB][6];
  for (int k = 0; k < 6; ++k) bias[0][k] = 0.0f;
#pragma unroll 1
  for (int i = 1; i < NB; ++i) {
    const int p = K.parent[i];
    const float qdi = st.qd[i - 1];
    float sqd[6], ca[3], c1[3], c2[3];
    for (int k = 0; k < 6; ++k) sqd[k] = sub[i][k] * qdi;
    cross3(&tw[i][0], &sqd[0], ca);
    cross3(&tw[i][0], &sqd[3], c1);
    cross3(&tw[i][3], &sqd[0], c2);
    for (int k = 0; k < 3; ++k) {
      bias[i][k] = bias[p][k] + ca[k];
      bias[i][3 + k] = bias[p][3 + k] + (c1[k] + c2[k]);
    }
  }

  // body forces, accumulated to the root
  float f_acc[NB][6];
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    const float* w = &tw[b][0];
    const float* v = &tw[b][3];
    const float* ba_w = &bias[b][0];
    const float* ba_v = &bias[b][3];
    float t0[3], t1[3], l_mom[3], p_mom[3], ia_ang[3], ia_lin[3], c1[3], c2[3];
    m3vec(io[b], w, t0);
    cross3(h[b], v, t1);
    for (int k = 0; k < 3; ++k) l_mom[k] = t0[k] + t1[k];
    cross3(w, h[b], t1);
    for (int k = 0; k < 3; ++k) p_mom[k] = v[k] * mass[b] + t1[k];
    m3vec(io[b], ba_w, t0);
    cross3(h[b], ba_v, t1);
    for (int k = 0; k < 3; ++k) ia_ang[k] = t0[k] + t1[k];
    cross3(ba_w, h[b], t1);
    for (int k = 0; k < 3; ++k) ia_lin[k] = ba_v[k] * mass[b] + t1[k];
    cross3(w, l_mom, c1);
    cross3(v, p_mom, c2);
    for (int k = 0; k < 3; ++k) f_acc[b][k] = (ia_ang[k] + (c1[k] + c2[k])) - e_ang[b][k];
    cross3(w, p_mom, c1);
    for (int k = 0; k < 3; ++k) f_acc[b][3 + k] = (ia_lin[k] + c1[k]) - e_lin[b][k];
  }
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = K.parent[i];
    for (int k = 0; k < 6; ++k) f_acc[p][k] = f_acc[p][k] + f_acc[i][k];
  }
  float c_full[N6];
  for (int k = 0; k < 6; ++k) c_full[k] = f_acc[0][k];
  for (int i = 0; i < ND; ++i) {
    float s = 0.0f;
    for (int k = 0; k < 6; ++k) s = s + sub[i + 1][k] * f_acc[i + 1][k];
    c_full[6 + i] = s;
  }

  // CRBA composite inertias (subtree masses of bodies >= 1 come folded in
  // float64 from the host, like the lane program's Python-float sums)
  float cm0 = mass[0];
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = K.parent[i];
    if (p == 0) cm0 = cm0 + K.cm_sub[i];
    for (int k = 0; k < 3; ++k) h[p][k] = h[p][k] + h[i][k];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) io[p][a][c] = io[p][a][c] + io[i][a][c];
  }
  // (h and io now hold the composite ch and cio)
  float f_crb[ND][6];
#pragma unroll 1
  for (int j = 0; j < ND; ++j) {
    const int b = j + 1;
    const float* sw = &sub[b][0];
    const float* sv = &sub[b][3];
    float t0[3], t1[3];
    m3vec(io[b], sw, t0);
    cross3(h[b], sv, t1);
    for (int k = 0; k < 3; ++k) f_crb[j][k] = t0[k] + t1[k];
    cross3(sw, h[b], t1);
    for (int k = 0; k < 3; ++k) f_crb[j][3 + k] = sv[k] * K.cm_sub[b] + t1[k];
  }

  // lower triangle of M + ridge, packed row-major: L(i, j) = A[i*(i+1)/2 + j]
  float A[N6 * (N6 + 1) / 2];
#define L_(i, j) A[(i) * ((i) + 1) / 2 + (j)]
  const float* ch0 = h[0];
  const float nhx[3][3] = {{-0.0f, ch0[2], -ch0[1]},
                           {-ch0[2], -0.0f, ch0[0]},
                           {ch0[1], -ch0[0], -0.0f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j <= i; ++j) L_(i, j) = io[0][i][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) L_(3 + i, j) = nhx[i][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j <= i; ++j) L_(3 + i, 3 + j) = (i == j ? cm0 : 0.0f) + 0.0f;
  for (int i = 0; i < ND; ++i)
    for (int j = 0; j < 6; ++j) L_(6 + i, j) = f_crb[i][j];
  for (int i = 0; i < ND; ++i) {
    for (int j = 0; j <= i; ++j) {
      // dof j is an ancestor-or-self of dof i
      bool anc = false;
      for (int b = i + 1; b > 0; b = K.parent[b]) anc = anc || (b - 1 == j);
      float g = 0.0f;
      if (anc) {
        g = 0.0f;
        for (int k = 0; k < 6; ++k) g = g + f_crb[i][k] * sub[j + 1][k];
      }
      if (i == j) {
        g = g + K.armature[i];
        g = g + dt * damp[i];
      }
      L_(6 + i, 6 + j) = g;
    }
  }
  for (int i = 0; i < N6; ++i) L_(i, i) = L_(i, i) + 1e-6f;

  // unrolled Cholesky, in place (ops/linalg semantics)
  float rhs[N6];
  for (int k = 0; k < 6; ++k) rhs[k] = -c_full[k];
  for (int i = 0; i < ND; ++i) rhs[6 + i] = tau[i] - c_full[6 + i];
#pragma unroll
  for (int j = 0; j < N6; ++j) {
    const float d = sqrtf(nmax(L_(j, j), 1e-12f));
    const float inv_d = 1.0f / d;
    L_(j, j) = d;
#pragma unroll
    for (int i = j + 1; i < N6; ++i) L_(i, j) = L_(i, j) * inv_d;
#pragma unroll
    for (int i = j + 1; i < N6; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) L_(i, k) = L_(i, k) - L_(i, j) * L_(k, j);
  }
  float y[N6], x[N6];
#pragma unroll
  for (int i = 0; i < N6; ++i) {
    float acc = rhs[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - L_(i, j) * y[j];
    y[i] = acc / L_(i, i);
  }
#pragma unroll
  for (int i = N6 - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int j = i + 1; j < N6; ++j) acc = acc - L_(j, i) * x[j];
    x[i] = acc / L_(i, i);
  }
#undef L_

  // ---- semi-implicit Euler ----
  float ang[3], lin[3], lin_acc[3], c[3];
  for (int k = 0; k < 3; ++k) ang[k] = clipf(st.ang[k] + x[k] * dt, -100.0f, 100.0f);
  cross3(st.ang, st.lin, c);
  for (int k = 0; k < 3; ++k) lin_acc[k] = x[3 + k] + c[k];
  for (int k = 0; k < 3; ++k) lin[k] = clipf(st.lin[k] + lin_acc[k] * dt, -100.0f, 100.0f);
  for (int k = 0; k < 3; ++k) st.pos[k] = st.pos[k] + lin[k] * dt;

  // quat_integrate: exact exponential map + renormalize
  float angle = sqrtf(nmax(dot3(ang, ang), 0.0f));
  float inv = 1.0f / nmax(angle, 1e-9f);
  float axis[3] = {ang[0] * inv, ang[1] * inv, ang[2] * inv};
  float dq[4], quat[4];
  q_from_angle_axis(angle * dt, axis, dq);
  qmul(dq, st.quat, quat);
  float qn = sqrtf(nmax(quat[0] * quat[0] + quat[1] * quat[1] + quat[2] * quat[2] +
                            quat[3] * quat[3],
                        0.0f));
  float qs = 1.0f / nmax(qn, 1e-9f);
  for (int k = 0; k < 4; ++k) st.quat[k] = quat[k] * qs;
  for (int k = 0; k < 3; ++k) { st.ang[k] = ang[k]; st.lin[k] = lin[k]; }
  for (int i = 0; i < ND; ++i) {
    st.qd[i] = clipf(st.qd[i] + x[6 + i] * dt, -100.0f, 100.0f);
    st.q[i] = st.q[i] + st.qd[i] * dt;
  }
  for (int p = 0; p < NP; ++p)
    for (int k = 0; k < 3; ++k) st.anchor[p][k] = new_anchor[p][k];
}

// ---------------------------------------------------------------------------
// the control law (ScalarDecimation.torques) and the post-physics stage
// (LanePost.run): both kernels call these, so the one-thread kernel stays the
// team kernel's bit-for-bit reference for every program
// ---------------------------------------------------------------------------

// one dof's torque before the motor strength and the clip
template <class S>
__device__ __forceinline__ float control_law(const ModelConst<S>& K, int d, float scaled, float q,
                                             float qd, float last_qd) {
  if constexpr (CTRL == 0) {
    return K.p_gain[d] * (scaled + K.default_q[d] - q) - K.d_gain[d] * qd;
  } else if constexpr (CTRL == 1) {
    return K.p_gain[d] * (scaled - qd) - (K.d_gain[d] * (qd - last_qd)) / K.dt;
  } else {
    return scaled;
  }
}

// post-stage values of one env: the one-thread kernel keeps them in the
// thread, the team kernel in shared memory (written by lane 0, read by the
// reward lanes)
template <class S>
struct PostVals {
  float blv[3], bav[3], pg[3], torso_pg[3], forehead_pg[3];
  float feet_height[S::NF], feet_force[S::NF][3], fat[S::NF], flt[S::NF], first_contact[S::NF];
  float cmd_active, bho, pen_count;
  int feet_contact[S::NF], contact_filt[S::NF], term, tilt, fin;
};

// the net force of contact-point group g of a (start, count, points) list
__device__ __forceinline__ void group_force(const int* start, const int* count, const int* pts, int g,
                                            const float (*forces)[3], float* gf) {
  for (int k = 0; k < 3; ++k) {
    float acc = 0.0f;
    for (int m = 0; m < count[g]; ++m) acc = acc + forces[pts[start[g] + m]][k];
    gf[k] = acc;
  }
}

__device__ __forceinline__ float norm3(const float* v) { return sqrtf(nmax(dot3(v, v), 0.0f)); }

// the gravity direction in a frame (the body of post slot `slot`, turned by
// qoff), or the base's where the model has no such frame
template <class S, class QA>
__device__ __forceinline__ void frame_pg(const ModelConst<S>& K, const QA& quats, int slot, const float* qoff,
                                         const float* pg, float* out) {
  if (slot >= 0) {
    const float down[3] = {0.0f, 0.0f, -1.0f};
    float fq[4];
    qmul(quats[K.post_body[slot]], qoff, fq);
    qrotinv(fq, down, out);
  } else {
    for (int k = 0; k < 3; ++k) out[k] = pg[k];
  }
}

// LanePost.run up to the reward terms, from the final state, its FK (quats,
// pos_rel of every body), the last substep's point forces and the stage's
// inputs
template <class S, class QA, class RA>
__device__ void post_values(const ModelConst<S>& K, PostVals<S>& P, const float* pos, const float* quat,
                            const float* lin, const float* ang, const float* q, const float* qd,
                            const QA& quats, const RA& pos_rel, const float (*forces)[3],
                            const float* fc_last, const float* fat_in, const float* flt_in,
                            const float* cmd) {
  constexpr int ND = S::ND, NF = S::NF;
  const float down[3] = {0.0f, 0.0f, -1.0f};
  qrotinv(quat, lin, P.blv);
  qrotinv(quat, ang, P.bav);
  qrotinv(quat, down, P.pg);
  frame_pg<S>(K, quats, K.torso_slot, K.torso_qoff, P.pg, P.torso_pg);
  frame_pg<S>(K, quats, K.forehead_slot, K.forehead_qoff, P.pg, P.forehead_pg);
  for (int f = 0; f < NF; ++f) {
    const int b = K.post_body[K.feet_slot[f]];
    float v[3];
    qapply(quats[b], K.feet_offset[f], v);
    P.feet_height[f] = pos[2] + (pos_rel[b][2] + 0.0f) + v[2];
  }
  for (int g = 0; g < NF; ++g) group_force(K.feet_start, K.feet_count, K.feet_pts, g, forces, P.feet_force[g]);
  for (int f = 0; f < NF; ++f) {
    const bool fc = P.feet_force[f][2] > 1.0f;
    const bool filt = fc | (fc_last[f] > 0.5f);
    P.feet_contact[f] = fc;
    P.contact_filt[f] = filt;
    P.first_contact[f] = b2f((fat_in[f] > 0.0f) & filt);
    P.fat[f] = fat_in[f] + K.dt_policy;
    P.flt[f] = (flt_in[f] + K.dt_policy) * b2f(fc);
  }
  bool term = false;
  for (int g = 0; g < K.n_term; ++g) {
    float gf[3];
    group_force(K.term_start, K.term_count, K.term_pts, g, forces, gf);
    term = term | (norm3(gf) > 1.0f);
  }
  P.term = term;
  P.tilt = fabsf(P.pg[2]) < 0.33f;
  bool fin = isfinite((pos[0] + pos[1] + pos[2]) + (quat[0] + quat[1] + quat[2] + quat[3]));
  for (int i = 0; i < ND; ++i) fin = fin & isfinite(q[i]) & isfinite(qd[i]);
  P.fin = fin;
  // the penalized contact groups in touch (a force over 0.1 N)
  float pen = 0.0f;
  for (int g = 0; g < S::NPEN; ++g) {
    float gf[3];
    group_force(K.pen_start, K.pen_count, K.pen_pts, g, forces, gf);
    pen = pen + b2f(norm3(gf) > 0.1f);
  }
  P.pen_count = pen;
  P.bho = clipf(pos[2] - K.target_h, -1.0f, 1.0f) * K.hscale;
  P.cmd_active = b2f(sqrtf(cmd[0] * cmd[0] + cmd[1] * cmd[1]) > 0.1f);
}

// what the reward terms read of one env
template <class S>
struct RewardIn {
  const ModelConst<S>& K;
  const PostVals<S>& P;
  const float *actions, *last_actions, *lla, *q, *qd, *last_qd, *cmd, *taus, *force_sum, *pos;
  const float (*vxyz)[3];
};

// sums over dofs: all of them (idx null) or a list's
__device__ __forceinline__ float sum_abs(const float* x, const int* idx, int n) {
  float err = 0.0f;
  for (int m = 0; m < n; ++m) err = err + fabsf(x[idx ? idx[m] : m]);
  return err;
}
__device__ __forceinline__ float sum_sq(const float* x, int n) {
  float err = 0.0f;
  for (int i = 0; i < n; ++i) err = err + x[i] * x[i];
  return err;
}

// The reward terms, one function a term (LanePost._rw_<name>; sig is the
// term's sigma). The ETH terms (no sigma) come last.
#define K1_TERM(name) template <class S> __device__ float name(const RewardIn<S>& R, float sig)

K1_TERM(rw_collision) { return 1.0f - expf(sig * R.P.pen_count); }
K1_TERM(rw_stand_still) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + fabsf(R.q[i] - R.K.default_q[i]);
  return expf(sig * err) * (1.0f - R.P.cmd_active);
}
K1_TERM(rw_cmd_lin_vel_x) { return expf(sig * fabsf(R.cmd[0] - R.P.blv[0])); }
K1_TERM(rw_cmd_lin_vel_y) { return expf(sig * fabsf(R.cmd[1] - R.P.blv[1])); }
K1_TERM(rw_cmd_lin_vel_z) { return expf(sig * fabsf(R.P.blv[2])); }
K1_TERM(rw_cmd_ang_vel_roll) { return expf(sig * fabsf(R.P.bav[0])); }
K1_TERM(rw_cmd_ang_vel_pitch) { return expf(sig * fabsf(R.P.bav[1])); }
K1_TERM(rw_cmd_ang_vel_yaw) { return expf(sig * fabsf(R.cmd[2] - R.P.bav[2])); }
K1_TERM(rw_cmd_base_height) { return expf(sig * (fabsf(R.P.bho) * b2f(R.P.bho < 0.0f))); }
K1_TERM(rw_cmd_base_orient) { return expf(sig * (fabsf(R.P.pg[0]) + fabsf(R.P.pg[1]))); }
K1_TERM(rw_cmd_torso_orient) { return expf(sig * (fabsf(R.P.torso_pg[0]) + fabsf(R.P.torso_pg[1]))); }
K1_TERM(rw_cmd_forehead_orient) { return expf(sig * (fabsf(R.P.forehead_pg[0]) + fabsf(R.P.forehead_pg[1]))); }
K1_TERM(rw_action_diff) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + fabsf((R.last_actions[i] - R.actions[i]) * R.K.action_scale);
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_action_diff_diff) {
  const float as = R.K.action_scale;
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i)
    err = err + fabsf((R.last_actions[i] - R.actions[i]) * as - (R.lla[i] - R.last_actions[i]) * as);
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_action_diff_knee) {
  float err = 0.0f;
  for (int m = 0; m < R.K.n_knee; ++m) {
    const int i = R.K.knee[m];
    err = err + fabsf((R.actions[i] - R.last_actions[i]) * R.K.action_scale);
  }
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_dof_vel_new) { return 1.0f - expf(sig * sum_abs(R.qd, nullptr, S::ND)); }
K1_TERM(rw_dof_vel_new_knee) { return 1.0f - expf(sig * sum_abs(R.qd, R.K.knee, R.K.n_knee)); }
K1_TERM(rw_dof_acc_new) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + fabsf((R.qd[i] - R.last_qd[i]) / R.K.dt_policy);
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_dof_tor_new) { return 1.0f - expf(sig * sum_abs(R.taus, nullptr, S::ND)); }
K1_TERM(rw_dof_tor_new_hip_roll) { return 1.0f - expf(sig * sum_abs(R.taus, R.K.hip_roll, R.K.n_hip_roll)); }
K1_TERM(rw_pose_offset) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + fabsf(R.q[i] - R.K.default_q[i]);
  return expf(sig * err);
}
K1_TERM(rw_pose_offset_hip_yaw) {
  float err = 0.0f;
  for (int m = 0; m < R.K.n_hip_yaw; ++m) {
    const int i = R.K.hip_yaw[m];
    err = err + fabsf(R.q[i] - R.K.default_q[i]);
  }
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_limits_dof_pos) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) {
    const float lo = -nmin(R.q[i] - R.K.soft_lo[i], 0.0f);
    const float hi = nmax(R.q[i] - R.K.soft_hi[i], 0.0f);
    err = err + fabsf(lo + hi);
  }
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_limits_dof_vel) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + clipf(fabsf(R.qd[i]) - R.K.vel_soft[i], 0.0f, 1.0f);
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_limits_dof_tor) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + nmax(fabsf(R.taus[i]) - R.K.tor_soft[i], 0.0f);
  return 1.0f - expf(sig * err);
}
K1_TERM(rw_dof_tor_ankle_lift) {
  const float sl = sum_abs(R.taus, R.K.ankle_left, R.K.n_ankle_left);
  const float sr = sum_abs(R.taus, R.K.ankle_right, R.K.n_ankle_right);
  const float lh = R.P.feet_height[0], rh = R.P.feet_height[1];
  const float err_l = sl * fabsf(lh) * b2f(lh > R.K.swing_half);
  const float err_r = sr * fabsf(rh) * b2f(rh > R.K.swing_half);
  return 1.0f - expf(sig * (err_l + err_r));
}
K1_TERM(rw_feet_speed_xy) {
  const ModelConst<S>& K = R.K;
  float err = 0.0f;
  for (int f = 0; f < S::NF; ++f) {
    const float h = R.P.feet_height[f];
    const float closeness = fabsf(h - K.swing_quarter) * b2f(h < K.swing_quarter) / K.swing_quarter;
    const float v0 = R.vxyz[f][0] / K.decimation_f, v1 = R.vxyz[f][1] / K.decimation_f;
    err = err + sqrtf(v0 * v0 + v1 * v1) * closeness;
  }
  return expf(sig * err);
}
K1_TERM(rw_feet_speed_z) {
  const ModelConst<S>& K = R.K;
  float err = 0.0f;
  for (int f = 0; f < S::NF; ++f) {
    const float h = R.P.feet_height[f];
    const float closeness = fabsf(h - K.swing_3q) * b2f(h > K.swing_3q) / K.swing_quarter;
    err = err + fabsf(R.vxyz[f][2] / K.decimation_f) * closeness;
  }
  return expf(sig * err);
}
K1_TERM(rw_feet_air_time) {
  float rew = 0.0f;
  for (int f = 0; f < S::NF; ++f)
    rew = rew + expf(sig * fabsf(R.P.fat[f] - R.K.fat_target)) * R.P.first_contact[f];
  return rew * R.P.cmd_active;
}
K1_TERM(rw_feet_air_height) {
  const float* fh = R.P.feet_height;
  float min_h = fh[0];
  for (int f = 1; f < S::NF; ++f) min_h = nmin(min_h, fh[f]);
  float err = 0.0f;
  for (int f = 0; f < S::NF; ++f) {
    const float err_h = fabsf(fh[f] - min_h - R.K.swing_target);
    const float mid = fabsf(R.P.fat[f] - R.K.fat_half);
    err = err + mid * err_h;
  }
  return expf(sig * err) * R.P.cmd_active;
}
K1_TERM(rw_feet_air_force) {
  float err = 0.0f;
  for (int f = 0; f < S::NF; ++f)
    err = err + fabsf(R.P.fat[f] - R.K.fat_half) * (R.force_sum[f] / R.K.decimation_f);
  return expf(sig * err) * R.P.cmd_active;
}
K1_TERM(rw_feet_land_time) {
  float rew = 0.0f;
  for (int f = 0; f < S::NF; ++f) {
    const float flt = R.P.flt[f];
    rew = rew + (1.0f - expf(sig * (flt - R.K.flt_max) * b2f(flt > R.K.flt_max)));
  }
  return rew * R.P.cmd_active;
}
K1_TERM(rw_on_the_air) {
  float n_contact = 0.0f;
  for (int f = 0; f < S::NF; ++f) n_contact = n_contact + b2f(R.P.feet_contact[f]);
  return b2f(n_contact == 0.0f);
}
K1_TERM(rw_feet_stumble) {
  float rew = 0.0f;
  for (int f = 0; f < S::NF; ++f) {
    const float* fo = R.P.feet_force[f];
    const float err = nmax(sqrtf(fo[0] * fo[0] + fo[1] * fo[1]) - R.K.stumble_ratio * fabsf(fo[2]), 0.0f);
    rew = rew + (1.0f - expf(sig * err));
  }
  return rew;
}
K1_TERM(rw_limits_actions) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) {
    const float scaled = R.actions[i] * R.K.action_scale;
    const float under = nmin(scaled - R.K.soft_lo[i], 0.0f);
    const float over = nmax(scaled - R.K.soft_hi[i], 0.0f);
    const float d = over - under;
    err = err + d * d;
  }
  return 1.0f - expf(sig * err);
}
// ETH base terms
K1_TERM(rw_lin_vel_z) { return R.P.blv[2] * R.P.blv[2]; }
K1_TERM(rw_ang_vel_xy) { return R.P.bav[0] * R.P.bav[0] + R.P.bav[1] * R.P.bav[1]; }
K1_TERM(rw_orientation) { return R.P.pg[0] * R.P.pg[0] + R.P.pg[1] * R.P.pg[1]; }
K1_TERM(rw_torques) { return sum_sq(R.taus, S::ND); }
K1_TERM(rw_dof_vel) { return sum_sq(R.qd, S::ND); }
K1_TERM(rw_dof_acc) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) {
    const float a = (R.qd[i] - R.last_qd[i]) / R.K.dt_policy;
    err = err + a * a;
  }
  return err;
}
K1_TERM(rw_action_rate) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) {
    const float d = R.last_actions[i] - R.actions[i];
    err = err + d * d;
  }
  return err;
}
K1_TERM(rw_tracking_lin_vel) {
  const float dx = R.cmd[0] - R.P.blv[0], dy = R.cmd[1] - R.P.blv[1];
  const float err = dx * dx + dy * dy;
  return expf(-err / R.K.tracking_sigma);
}
K1_TERM(rw_tracking_ang_vel) {
  const float d = R.cmd[2] - R.P.bav[2];
  const float err = d * d;
  return expf(-err / R.K.tracking_sigma);
}
K1_TERM(rw_feet_contact_forces) {
  float err = 0.0f;
  for (int f = 0; f < S::NF; ++f) err = err + nmax(norm3(R.P.feet_force[f]) - R.K.max_contact_force, 0.0f);
  return err;
}
K1_TERM(rw_base_height) {
  const float d = R.pos[2] - R.K.target_h;
  return d * d;
}
K1_TERM(rw_dof_pos_limits) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) {
    const float under = nmin(R.q[i] - R.K.soft_lo[i], 0.0f);
    const float over = nmax(R.q[i] - R.K.soft_hi[i], 0.0f);
    err = err + (over - under);
  }
  return err;
}
K1_TERM(rw_dof_vel_limits) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + clipf(fabsf(R.qd[i]) - R.K.vel_soft[i], 0.0f, 1.0f);
  return err;
}
K1_TERM(rw_torque_limits) {
  float err = 0.0f;
  for (int i = 0; i < S::ND; ++i) err = err + nmax(fabsf(R.taus[i]) - R.K.tor_soft[i], 0.0f);
  return err;
}
K1_TERM(rw_stumble) {
  bool any = false;
  for (int f = 0; f < S::NF; ++f) {
    const float* fo = R.P.feet_force[f];
    any = any | (sqrtf(fo[0] * fo[0] + fo[1] * fo[1]) > 5.0f * fabsf(fo[2]));
  }
  return b2f(any);
}
#undef K1_TERM

// reward term r of the program, scaled; 0 in a NaN env (a select, not a
// product: NaN * 0 is NaN)
template <class S>
__device__ float reward_term(int r, const RewardIn<S>& R) {
  const float sig = R.K.sigma[r];
  float val;
  switch (R.K.reward_id[r]) {
    case RW_ACTION_DIFF: val = rw_action_diff<S>(R, sig); break;
    case RW_ACTION_DIFF_DIFF: val = rw_action_diff_diff<S>(R, sig); break;
    case RW_ACTION_DIFF_KNEE: val = rw_action_diff_knee<S>(R, sig); break;
    case RW_ACTION_RATE: val = rw_action_rate<S>(R, sig); break;
    case RW_ANG_VEL_XY: val = rw_ang_vel_xy<S>(R, sig); break;
    case RW_BASE_HEIGHT: val = rw_base_height<S>(R, sig); break;
    case RW_CMD_ANG_VEL_PITCH: val = rw_cmd_ang_vel_pitch<S>(R, sig); break;
    case RW_CMD_ANG_VEL_ROLL: val = rw_cmd_ang_vel_roll<S>(R, sig); break;
    case RW_CMD_ANG_VEL_YAW: val = rw_cmd_ang_vel_yaw<S>(R, sig); break;
    case RW_CMD_BASE_HEIGHT: val = rw_cmd_base_height<S>(R, sig); break;
    case RW_CMD_BASE_ORIENT: val = rw_cmd_base_orient<S>(R, sig); break;
    case RW_CMD_FOREHEAD_ORIENT: val = rw_cmd_forehead_orient<S>(R, sig); break;
    case RW_CMD_LIN_VEL_X: val = rw_cmd_lin_vel_x<S>(R, sig); break;
    case RW_CMD_LIN_VEL_Y: val = rw_cmd_lin_vel_y<S>(R, sig); break;
    case RW_CMD_LIN_VEL_Z: val = rw_cmd_lin_vel_z<S>(R, sig); break;
    case RW_CMD_TORSO_ORIENT: val = rw_cmd_torso_orient<S>(R, sig); break;
    case RW_COLLISION: val = rw_collision<S>(R, sig); break;
    case RW_DOF_ACC: val = rw_dof_acc<S>(R, sig); break;
    case RW_DOF_ACC_NEW: val = rw_dof_acc_new<S>(R, sig); break;
    case RW_DOF_POS_LIMITS: val = rw_dof_pos_limits<S>(R, sig); break;
    case RW_DOF_TOR_ANKLE_LIFT: val = rw_dof_tor_ankle_lift<S>(R, sig); break;
    case RW_DOF_TOR_NEW: val = rw_dof_tor_new<S>(R, sig); break;
    case RW_DOF_TOR_NEW_HIP_ROLL: val = rw_dof_tor_new_hip_roll<S>(R, sig); break;
    case RW_DOF_VEL: val = rw_dof_vel<S>(R, sig); break;
    case RW_DOF_VEL_LIMITS: val = rw_dof_vel_limits<S>(R, sig); break;
    case RW_DOF_VEL_NEW: val = rw_dof_vel_new<S>(R, sig); break;
    case RW_DOF_VEL_NEW_KNEE: val = rw_dof_vel_new_knee<S>(R, sig); break;
    case RW_FEET_AIR_FORCE: val = rw_feet_air_force<S>(R, sig); break;
    case RW_FEET_AIR_HEIGHT: val = rw_feet_air_height<S>(R, sig); break;
    case RW_FEET_AIR_TIME: val = rw_feet_air_time<S>(R, sig); break;
    case RW_FEET_CONTACT_FORCES: val = rw_feet_contact_forces<S>(R, sig); break;
    case RW_FEET_LAND_TIME: val = rw_feet_land_time<S>(R, sig); break;
    case RW_FEET_SPEED_XY: val = rw_feet_speed_xy<S>(R, sig); break;
    case RW_FEET_SPEED_Z: val = rw_feet_speed_z<S>(R, sig); break;
    case RW_FEET_STUMBLE: val = rw_feet_stumble<S>(R, sig); break;
    case RW_LIMITS_ACTIONS: val = rw_limits_actions<S>(R, sig); break;
    case RW_LIMITS_DOF_POS: val = rw_limits_dof_pos<S>(R, sig); break;
    case RW_LIMITS_DOF_TOR: val = rw_limits_dof_tor<S>(R, sig); break;
    case RW_LIMITS_DOF_VEL: val = rw_limits_dof_vel<S>(R, sig); break;
    case RW_LIN_VEL_Z: val = rw_lin_vel_z<S>(R, sig); break;
    case RW_ON_THE_AIR: val = rw_on_the_air<S>(R, sig); break;
    case RW_ORIENTATION: val = rw_orientation<S>(R, sig); break;
    case RW_POSE_OFFSET: val = rw_pose_offset<S>(R, sig); break;
    case RW_POSE_OFFSET_HIP_YAW: val = rw_pose_offset_hip_yaw<S>(R, sig); break;
    case RW_STAND_STILL: val = rw_stand_still<S>(R, sig); break;
    case RW_STUMBLE: val = rw_stumble<S>(R, sig); break;
    case RW_TORQUE_LIMITS: val = rw_torque_limits<S>(R, sig); break;
    case RW_TORQUES: val = rw_torques<S>(R, sig); break;
    case RW_TRACKING_ANG_VEL: val = rw_tracking_ang_vel<S>(R, sig); break;
    case RW_TRACKING_LIN_VEL: val = rw_tracking_lin_vel<S>(R, sig); break;
    default: val = __int_as_float(0x7fc00000); break;  // unknown id: NaN
  }
  return R.P.fin ? R.K.scale[r] * val : 0.0f;
}

// ---------------------------------------------------------------------------
// the kernel: one thread per env
// ---------------------------------------------------------------------------

template <class S>
__global__ void __launch_bounds__(THREADS)
decimation_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const ModelConst<S>& K = c_model;
  constexpr int NB = S::NB, ND = S::ND, NP = S::NP, NF = S::NF;

  auto ld = [&](int group, int k) { return in[(size_t)(K.in_off[group] + k) * n + e]; };
  auto st_ = [&](int group, int k, float v) { out[(size_t)(K.out_off[group] + k) * n + e] = v; };

  State<S> st;
  for (int k = 0; k < 3; ++k) { st.pos[k] = ld(IN_POS, k); st.lin[k] = ld(IN_LIN, k); st.ang[k] = ld(IN_ANG, k); }
  for (int k = 0; k < 4; ++k) st.quat[k] = ld(IN_QUAT, k);
  for (int i = 0; i < ND; ++i) { st.q[i] = ld(IN_Q, i); st.qd[i] = ld(IN_QD, i); }
  for (int p = 0; p < NP; ++p)
    for (int k = 0; k < 3; ++k) st.anchor[p][k] = ld(IN_ANCHOR, 3 * p + k);
  float actions[ND], last_actions[ND], motor[ND];
  for (int i = 0; i < ND; ++i) {
    actions[i] = ld(IN_ACTIONS, i);
    last_actions[i] = ld(IN_LAST_ACTIONS, i);
    motor[i] = ld(IN_MOTOR, i);
  }
  // the ground lanes of every point (terrain modes)
  float plane[cap(PLANE_LANES * NP)];
  for (int c = 0; c < PLANE_LANES * NP; ++c) plane[c] = ld(IN_PLANE, c);
  const float delay = ld(IN_DELAY, 0);
  const float friction = ld(IN_FRICTION, 0);
  const float restitution = ld(IN_RESTITUTION, 0);
  const float mass_scale = ld(IN_MASS_SCALE, 0);
  float com_offset[3];
  for (int k = 0; k < 3; ++k) com_offset[k] = ld(IN_COM_OFFSET, k);
  float last_qd[ND];
  for (int i = 0; i < ND; ++i) last_qd[i] = WITH_LAST_QD ? ld(IN_LAST_QD, i) : 0.0f;

  float force_sum[NF], vxyz[NF][3], vrpy[NF][3];
  for (int g = 0; g < NF; ++g) {
    force_sum[g] = 0.0f;
    for (int k = 0; k < 3; ++k) { vxyz[g][k] = 0.0f; vrpy[g][k] = 0.0f; }
  }
  float quats[NB][4], pos_rel[NB][3], sub[NB][6], tw[NB][6], forces[NP][3];
  float taus[ND];

#pragma unroll 1
  for (int s = 0; s < K.decimation; ++s) {
    const bool gate = (float)s < delay;
    float damp[ND];
    for (int d = 0; d < ND; ++d) {
      const float use_act = gate ? last_actions[d] : actions[d];
      const float scaled = use_act * K.action_scale;
      const float t = control_law<S>(K, d, scaled, st.q[d], st.qd[d], last_qd[d]);
      const float lim = K.torque_limit[d];
      taus[d] = clipf(t * motor[d], -lim, lim);
      damp[d] = K.has_damp ? K.damp_coeff[d] * motor[d] : 0.0f;
    }
    substep<S>(st, taus, damp, friction, restitution, mass_scale, com_offset, plane, quats,
               pos_rel, sub, tw, forces);
    for (int g = 0; g < NF; ++g) {
      const int p0 = K.feet_start[g], cnt = K.feet_count[g];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      for (int m = 0; m < cnt; ++m) {
        const int p = K.feet_pts[p0 + m];
        fx = fx + forces[p][0];
        fy = fy + forces[p][1];
        fz = fz + forces[p][2];
      }
      force_sum[g] = force_sum[g] + sqrtf(fx * fx + fy * fy + fz * fz);
      const int b = K.feet_body[g];
      float c[3];
      cross3(&tw[b][0], pos_rel[b], c);
      for (int k = 0; k < 3; ++k) {
        vxyz[g][k] = vxyz[g][k] + fabsf(tw[b][3 + k] + c[k]);
        vrpy[g][k] = vrpy[g][k] + fabsf(tw[b][k]);
      }
    }
  }

  // final-state FK of the post bodies
  fk<S>(st.quat, st.ang, st.lin, st.q, st.qd, quats, pos_rel, sub, tw);
  float post_quat[S::NPOST][4], post_rel[S::NPOST][3];
  for (int s = 0; s < S::NPOST; ++s) {
    const int b = K.post_body[s];
    for (int k = 0; k < 4; ++k) post_quat[s][k] = quats[b][k];
    for (int k = 0; k < 3; ++k) post_rel[s][k] = pos_rel[b][k] + 0.0f;
  }

  // final-state world positions of the contact points (terrain modes)
  if constexpr (TERRAIN != 0) {
    for (int p = 0; p < NP; ++p) {
      const int b = K.point_body[p];
      float v[3];
      qapply(quats[b], K.point_offset[p], v);
      for (int k = 0; k < 3; ++k) st_(OUT_POINT_POS, 3 * p + k, st.pos[k] + (pos_rel[b][k] + v[k]));
    }
  }

  if constexpr (FOLD) {
    // ---- post-physics stage (LanePost.run) ----
    float fc_last[NF], fat_in[NF], flt_in[NF], cmd[3], lla[ND];
    for (int f = 0; f < NF; ++f) {
      fc_last[f] = ld(IN_FEET_CONTACT_LAST, f);
      fat_in[f] = ld(IN_FEET_AIR_TIME, f);
      flt_in[f] = ld(IN_FEET_LAND_TIME, f);
    }
    for (int k = 0; k < 3; ++k) cmd[k] = ld(IN_COMMANDS, k);
    for (int i = 0; i < ND; ++i) lla[i] = ld(IN_LAST_LAST_ACTIONS, i);
    PostVals<S> P;
    post_values<S>(K, P, st.pos, st.quat, st.lin, st.ang, st.q, st.qd, quats, pos_rel, forces, fc_last,
                   fat_in, flt_in, cmd);
    const RewardIn<S> R{K, P, actions, last_actions, lla, st.q, st.qd, last_qd, cmd, taus, force_sum,
                        st.pos, vxyz};
    for (int r = 0; r < S::NR; ++r) st_(OUT_REW_TERMS, r, reward_term<S>(r, R));

    // the post stage's outputs
    for (int k = 0; k < 3; ++k) { st_(OUT_BLV, k, P.blv[k]); st_(OUT_BAV, k, P.bav[k]); st_(OUT_PG, k, P.pg[k]); }
    for (int f = 0; f < NF; ++f) {
      st_(OUT_FEET_CONTACT, f, b2f(P.feet_contact[f]));
      st_(OUT_CONTACT_FILT, f, b2f(P.contact_filt[f]));
      st_(OUT_FIRST_CONTACT, f, P.first_contact[f]);
      st_(OUT_FEET_AIR_TIME, f, P.fat[f]);
      st_(OUT_FEET_LAND_TIME, f, P.flt[f]);
      st_(OUT_FEET_HEIGHT, f, P.feet_height[f]);
    }
    st_(OUT_TERM_CONTACT, 0, b2f(P.term));
    st_(OUT_TILT, 0, b2f(P.tilt));
    st_(OUT_BAD, 0, b2f(!P.fin));
    st_(OUT_BHO, 0, P.bho);
  }

  // ---- outputs ----
  for (int k = 0; k < 3; ++k) { st_(OUT_POS, k, st.pos[k]); st_(OUT_LIN, k, st.lin[k]); st_(OUT_ANG, k, st.ang[k]); }
  for (int k = 0; k < 4; ++k) st_(OUT_QUAT, k, st.quat[k]);
  for (int i = 0; i < ND; ++i) {
    st_(OUT_Q, i, st.q[i]); st_(OUT_QD, i, st.qd[i]); st_(OUT_TAU, i, taus[i]);
  }
  for (int p = 0; p < NP; ++p)
    for (int k = 0; k < 3; ++k) {
      st_(OUT_ANCHOR, 3 * p + k, st.anchor[p][k]);
      st_(OUT_POINT_FORCE, 3 * p + k, forces[p][k]);
    }
  for (int f = 0; f < NF; ++f) {
    st_(OUT_FORCE_SUM, f, force_sum[f]);
    for (int k = 0; k < 3; ++k) {
      st_(OUT_VXYZ_SUM, 3 * f + k, vxyz[f][k]);
      st_(OUT_VRPY_SUM, 3 * f + k, vrpy[f][k]);
    }
  }
  for (int s = 0; s < S::NPOST; ++s) {
    for (int k = 0; k < 4; ++k) st_(OUT_POST_QUAT, 4 * s + k, post_quat[s][k]);
    for (int k = 0; k < 3; ++k) st_(OUT_POST_REL, 3 * s + k, post_rel[s][k]);
  }
}

// ---------------------------------------------------------------------------
// the team kernel: T lanes of one warp per env, the env's arrays in shared
// memory. Every value is computed by the same float operations in the same
// order as in decimation_kernel above; only who computes it changes.
// ---------------------------------------------------------------------------

// One env's working set. Odd row strides (5, 3, 7, 9 floats) put the rows
// that the lanes of a team read at once in different banks. `u` holds what
// lives in one phase only: FK's joint quaternions, the contact phase's point
// velocities and pair forces, the dynamics arrays, the staged outputs, and
// where SHARED_LS (team_shared_ls) the factor of the mass matrix, which is
// written once the matrix rows are filled from the dynamics arrays and read
// by the back substitution; otherwise the factor has its own array.
template <class S, bool SHARED>
struct TeamEnvBody {
  static constexpr bool SHARED_LS = SHARED;
  static constexpr int N6 = 6 + S::ND, NLS = N6 * (N6 + 1) / 2;
  static constexpr int INP = (S::NIN + 15) / 32 * 32 + 16;  // = 16 (mod 32) words
  float in[INP];  // the inputs; the state (pos ... anchor) is updated in place
  float taus[S::ND], tau[S::ND], damp[S::ND];
  float quats[S::NB][5], pos_rel[S::NB][3], sub[S::NB][7], tw[S::NB][7];
  float pts_pos[S::NP][3], forces[S::NP][3];
  float force_sum[S::NF], vxyz[S::NF][3], vrpy[S::NF][3];
  float Ls[SHARED ? 1 : NLS], yacc[N6], y[N6], x[N6];
  PostVals<S> post;
  union {
    float qj[S::NB][5];
    struct { float pts_vel[S::NP][3], nf[cap(S::NPAIR)][3]; } c;
    struct {
      float e_ang[S::NB][3], e_lin[S::NB][3], h[S::NB][3], io[S::NB][9], bias[S::NB][7],
          f_acc[S::NB][7], f_crb[S::ND][7];
    } d;
    float Ls[SHARED ? NLS : 1];
    float outb[S::NOUT];
  } u;
  __host__ __device__ float* factor() { return SHARED ? u.Ls : Ls; }
};

// Where two or more teams share a warp (T < 32), consecutive envs' working
// sets start 16 words apart mod 32, so that the teams of a warp reading the
// same field hit different banks: the body is padded to 16 (mod 32) words.
// (Measured with scripts/time_k1.py on GR1T1, PERF.md section 6.)
template <class S, bool SHARED>
constexpr int team_env_pad() {
  constexpr int words = (int)(sizeof(TeamEnvBody<S, SHARED>) / 4);
  constexpr int pad = ((16 - words % 32) % 32 + 32) % 32;
  return pad == 0 ? 32 : pad;
}
template <class S, bool SHARED, bool PAD>
struct TeamEnvPadded : TeamEnvBody<S, SHARED> {
  float pad_[team_env_pad<S, SHARED>()];
};
template <class S, bool SHARED>
struct TeamEnvPadded<S, SHARED, false> : TeamEnvBody<S, SHARED> {};
template <class S, bool SHARED>
using TeamEnvOf = TeamEnvPadded<S, SHARED, (TEAM_T < 32)>;

template <class S>
__host__ __device__ constexpr int team_const_bytes() { return (int)((sizeof(ModelConst<S>) + 15) / 16 * 16); }
// The blocks an SM can hold: at most 16 warps, and as many as its 228 KB of
// shared memory hold (1 KB of it reserved a block).
template <class S, int T, int E, bool SHARED>
__host__ __device__ constexpr int team_blocks() {
  constexpr int smem = team_const_bytes<S>() + E * (int)sizeof(TeamEnvOf<S, SHARED>);
  return 233472 / (smem + 1024) < 512 / (T * E) ? 233472 / (smem + 1024) : 512 / (T * E);
}
// The factor shares the union only where that lets an SM hold more blocks
// (the 32-DOF body at 32 x 8: 2 blocks instead of 1). Where warps, not
// shared memory, bound the blocks (the 16 x 8 programs), it keeps its own
// array: the lower limb's K1 measured 3% slower with it shared (PERF.md
// section 6).
template <class S, int T, int E>
__host__ __device__ constexpr bool team_shared_ls() {
  return team_blocks<S, T, E, true>() > team_blocks<S, T, E, false>();
}
template <class S>
using TeamEnv = TeamEnvOf<S, team_shared_ls<S, TEAM_T, TEAM_E>()>;

template <class S, int E>
__host__ __device__ constexpr int team_smem_bytes() { return team_const_bytes<S>() + E * (int)sizeof(TeamEnv<S>); }
// The launch bounds ask for the blocks an SM holds, so the registers a
// thread may take follow the size set.
template <class S, int T, int E>
__host__ __device__ constexpr int team_min_blocks() {
  return team_blocks<S, T, E, TeamEnv<S>::SHARED_LS>();
}

// m3vec on a row-major 3x3 stored as 9 floats
__device__ __forceinline__ void m3vec9(const float* m, const float* v, float* o) {
  for (int r = 0; r < 3; ++r) o[r] = m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2];
}

// v[l] for l < N, else 0: a chain of selects (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float* v, int l) {
  float r = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) r = l == m ? v[m] : r;
  return r;
}

// The serial fill's entry of the mass matrix in dof row jr, column 6 + jj
// (dof jj): fc is the row's f_crb, anc its anc_mask, s dof jj's motion
// subspace, dd dt times the row's damping.
template <class S>
__device__ __forceinline__ float dof_entry(const ModelConst<S>& K, int jr, unsigned anc, const float* fc,
                                           const float* s, int jj, float dd) {
  float dot = 0.0f;
  for (int k = 0; k < 6; ++k) dot = dot + fc[k] * s[k];
  const float g = ((anc >> jj) & 1u) ? dot : 0.0f;
  const float gd = (g + K.armature[jr]) + dd;
  return jr == jj ? gd : g;
}

// FK over the static tree (fk<S> above), by the team: joint quaternions per
// body lane, then the tree level by level (a level's bodies on their own
// lanes).
template <class S, int T>
__device__ __forceinline__ void team_fk(const ModelConst<S>& K, TeamEnv<S>& V, const float* quat0, const float* ang,
                        const float* lin, const float* q, const float* qd, int l, unsigned mask) {
  constexpr int NB = S::NB;
  if (l == 0) {
    for (int k = 0; k < 4; ++k) V.quats[0][k] = quat0[k];
    for (int k = 0; k < 3; ++k) { V.pos_rel[0][k] = 0.0f; V.tw[0][k] = ang[k]; V.tw[0][3 + k] = lin[k]; }
    for (int k = 0; k < 6; ++k) V.sub[0][k] = 0.0f;
  }
  for (int i = 1 + l; i < NB; i += T) q_from_angle_axis(q[i - 1], K.axis_unit[i], V.u.qj[i]);
  __syncwarp(mask);
  for (int L = 0; L < K.n_levels; ++L) {
    for (int m = K.level_start[L] + l; m < K.level_start[L + 1]; m += T) {
      const int i = K.level_body[m], p = K.parent[i];
      float q_static[4], v[3], a_w[3], c[3];
      qmul(V.quats[p], K.tree_quat[i], q_static);
      qmul(q_static, V.u.qj[i], V.quats[i]);
      qapply(V.quats[p], K.tree_pos[i], v);
      for (int k = 0; k < 3; ++k) V.pos_rel[i][k] = V.pos_rel[p][k] + v[k];
      qapply(V.quats[i], K.axis[i], a_w);
      cross3(V.pos_rel[i], a_w, c);
      for (int k = 0; k < 3; ++k) { V.sub[i][k] = a_w[k]; V.sub[i][3 + k] = c[k]; }
      const float qdi = qd[i - 1];
      for (int k = 0; k < 6; ++k) V.tw[i][k] = V.tw[p][k] + V.sub[i][k] * qdi;
    }
    __syncwarp(mask);
  }
}

template <int T>
__device__ __forceinline__ unsigned team_mask(int tid) {
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u) << ((tid & 31) / T * T);
}

// Launch bounds: T * E threads, and the blocks an SM holds by warps and by
// shared memory (team_min_blocks): the GR1T1 lower limb at 16 x 8 gets 4
// blocks (16 warps), the 32-DOF body at 32 x 8 2 (16 warps), so at most 128
// registers a thread.
template <class S, int T, int E>
__global__ void __launch_bounds__(T * E, team_min_blocks<S, T, E>())
decimation_team_kernel(const ModelConst<S>* __restrict__ model, const float* __restrict__ in,
                       float* __restrict__ out, int n) {
  constexpr int NB = S::NB, ND = S::ND, NP = S::NP, NF = S::NF, N6 = 6 + S::ND, NT = T * E;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  ModelConst<S>& K = *reinterpret_cast<ModelConst<S>*>(k1_smem);
  TeamEnv<S>* envs = reinterpret_cast<TeamEnv<S>*>(k1_smem + team_const_bytes<S>());
  const int tid = threadIdx.x, l = tid % T, team = tid / T;
  const int e0 = blockIdx.x * E;
  const unsigned mask = team_mask<T>(tid);

  // the block's constants and inputs into shared memory; a team past the
  // last env runs on zeros and stores nothing
  {
    const int* src = reinterpret_cast<const int*>(model);
    int* dst = reinterpret_cast<int*>(&K);
    for (int i = tid; i < (int)(sizeof(ModelConst<S>) / 4); i += NT) dst[i] = src[i];
  }
  for (int idx = tid; idx < S::NIN * E; idx += NT) {
    const int c = idx / E, j = idx % E;
    envs[j].in[c] = (e0 + j < n) ? in[(size_t)c * n + e0 + j] : 0.0f;
  }
  __syncthreads();

  TeamEnv<S>& V = envs[team];
  float* const pos = V.in + K.in_off[IN_POS];
  float* const quat = V.in + K.in_off[IN_QUAT];
  float* const lin = V.in + K.in_off[IN_LIN];
  float* const ang = V.in + K.in_off[IN_ANG];
  float* const q = V.in + K.in_off[IN_Q];
  float* const qd = V.in + K.in_off[IN_QD];
  float* const anchor = V.in + K.in_off[IN_ANCHOR];
  const float* const actions = V.in + K.in_off[IN_ACTIONS];
  const float* const last_actions = V.in + K.in_off[IN_LAST_ACTIONS];
  const float* const motor = V.in + K.in_off[IN_MOTOR];
  const float* const com_offset = V.in + K.in_off[IN_COM_OFFSET];
  const float delay = V.in[K.in_off[IN_DELAY]];
  const float friction = V.in[K.in_off[IN_FRICTION]];
  const float restitution = V.in[K.in_off[IN_RESTITUTION]];
  const float mass_scale = V.in[K.in_off[IN_MASS_SCALE]];
  const float* const plane = V.in + K.in_off[IN_PLANE];  // the ground lanes (terrain modes)
  const float* const last_qd = V.in + K.in_off[IN_LAST_QD];  // (WITH_LAST_QD)
  const float dt = K.dt;
#define TLS(i, j) V.factor()[(i) * ((i) + 1) / 2 + (j)]

  for (int g = l; g < NF; g += T) {
    V.force_sum[g] = 0.0f;
    for (int k = 0; k < 3; ++k) { V.vxyz[g][k] = 0.0f; V.vrpy[g][k] = 0.0f; }
  }

  for (int s = 0; s < K.decimation; ++s) {
    // PD torques and the joint limits, per dof lane
    const bool gate = (float)s < delay;
    for (int d = l; d < ND; d += T) {
      const float use_act = gate ? last_actions[d] : actions[d];
      const float scaled = use_act * K.action_scale;
      const float t = control_law<S>(K, d, scaled, q[d], qd[d], WITH_LAST_QD ? last_qd[d] : 0.0f);
      const float lim = K.torque_limit[d];
      const float tq = clipf(t * motor[d], -lim, lim);
      V.taus[d] = tq;
      float tau = tq;
      float damp = K.has_damp ? K.damp_coeff[d] * motor[d] : 0.0f;
      if (K.use_joint_limits) {
        float over = nmax(q[d] - K.dof_upper[d], 0.0f);
        float under = nmax(K.dof_lower[d] - q[d], 0.0f);
        float viol = b2f((over > 0.0f) | (under > 0.0f));
        float lim_damp = K.lim_damp[d] * viol;
        tau = tau + K.lim_k[d] * (under - over) - lim_damp * qd[d];
        damp = damp + lim_damp;
      }
      V.tau[d] = tau;
      V.damp[d] = damp;
    }
    team_fk<S, T>(K, V, quat, ang, lin, q, qd, l, mask);

    // ground contact, per point lane; the anchors are updated in place.
    // A lane's points are computed first and stored after, so that the
    // compiler may overlap them.
    {
      constexpr int RP = (NP + T - 1) / T;
      const float mu = friction;
      const float zeta = K.damping_ratio * clipf(1.0f - restitution, 0.05f, 1.0f);
      const float d_n = nmin(2.0f * zeta * K.sqrt_kpm, K.imp_cap);
      float pw[RP][3], vel[RP][3], fo[RP][3], na[RP][3];
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const int p = l + rr * T;
        if (p < NP) {
          const int b = K.point_body[p];
          float v[3], rel[3], c[3];
          qapply(V.quats[b], K.point_offset[p], v);
          for (int k = 0; k < 3; ++k) rel[k] = V.pos_rel[b][k] + v[k];
          cross3(&V.tw[b][0], rel, c);
          for (int k = 0; k < 3; ++k) {
            vel[rr][k] = V.tw[b][3 + k] + c[k];
            pw[rr][k] = pos[k] + rel[k];
          }
          point_contact<S>(K, K.point_radius[p], pw[rr], vel[rr], anchor + 3 * p, plane + PLANE_LANES * p,
                           mu, d_n, fo[rr], na[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const int p = l + rr * T;
        if (p < NP) {
          for (int k = 0; k < 3; ++k) {
            V.pts_pos[p][k] = pw[rr][k];
            V.u.c.pts_vel[p][k] = vel[rr][k];
            V.forces[p][k] = fo[rr][k];
            anchor[3 * p + k] = na[rr][k];
          }
        }
      }
    }
    __syncwarp(mask);

    // self-collision: each pair's force per pair lane (computed first,
    // stored after), then each point lane adds its pairs' terms in
    // ascending pair order (the serial loop's)
    {
      constexpr int RS = (S::NPAIR + T - 1) / T;
      float nfv[cap(RS)][3];
#pragma unroll
      for (int rr = 0; rr < RS; ++rr) {
        const int sp = l + rr * T;
        if (sp < S::NPAIR) {
          const int i = K.pair_i[sp], j = K.pair_j[sp];
          float d[3], nrm[3], rel_v[3];
          for (int k = 0; k < 3; ++k) d[k] = V.pts_pos[i][k] - V.pts_pos[j][k];
          float dist = sqrtf(nmax(dot3(d, d), 0.0f));
          float inv = 1.0f / nmax(dist, 1e-6f);
          for (int k = 0; k < 3; ++k) nrm[k] = d[k] * inv;
          float pen = K.pair_rsum[sp] - dist;
          bool active = pen > 0.0f;
          for (int k = 0; k < 3; ++k) rel_v[k] = V.u.c.pts_vel[i][k] - V.u.c.pts_vel[j][k];
          float v_n = dot3(rel_v, nrm);
          float f_mag = nmax(K.k_self * nmin(pen, 0.1f) - K.d_ns * v_n, 0.0f);
          f_mag = active ? f_mag : 0.0f;
          for (int k = 0; k < 3; ++k) nfv[rr][k] = nrm[k] * f_mag;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RS; ++rr) {
        const int sp = l + rr * T;
        if (sp < S::NPAIR)
          for (int k = 0; k < 3; ++k) V.u.c.nf[sp][k] = nfv[rr][k];
      }
    }
    __syncwarp(mask);
    for (int p = l; p < NP; p += T) {
      float f0 = V.forces[p][0], f1 = V.forces[p][1], f2 = V.forces[p][2];
      for (int m = K.pt_pair_start[p]; m < K.pt_pair_start[p + 1]; ++m) {
        const int code = K.pt_pair[m];
        const float* nf = V.u.c.nf[code >> 1];
        if (code & 1) {
          f0 = f0 - nf[0]; f1 = f1 - nf[1]; f2 = f2 - nf[2];
        } else {
          f0 = f0 + nf[0]; f1 = f1 + nf[1]; f2 = f2 + nf[2];
        }
      }
      V.forces[p][0] = f0; V.forces[p][1] = f1; V.forces[p][2] = f2;
    }
    __syncwarp(mask);

    // per body lane: the contact wrench (its points in ascending order),
    // world inertia, gravity wrench and the bias-acceleration increment
    for (int b = l; b < NB; b += T) {
      float ea[3] = {0.0f, 0.0f, 0.0f}, el[3] = {0.0f, 0.0f, 0.0f};
      for (int m = K.body_pt_start[b]; m < K.body_pt_start[b + 1]; ++m) {
        const int p = K.body_pts[m];
        float rel[3], c[3];
        for (int k = 0; k < 3; ++k) rel[k] = V.pts_pos[p][k] - pos[k];
        cross3(rel, V.forces[p], c);
        for (int k = 0; k < 3; ++k) {
          ea[k] = ea[k] + c[k];
          el[k] = el[k] + V.forces[p][k];
        }
      }
      const float m_b = (b == 0) ? K.mass[0] * mass_scale : K.mass[b];
      const float* qb = V.quats[b];
      float qx = qb[0], qy = qb[1], qz = qb[2], qw = qb[3];
      float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      float xy = qx * qy, xz = qx * qz, yz = qy * qz;
      float wx = qw * qx, wy = qw * qy, wz = qw * qz;
      float r[3][3] = {
          {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy)},
          {2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx)},
          {2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)}};
      float cl[3], v[3], cr[3];
      for (int k = 0; k < 3; ++k) cl[k] = (b == 0) ? K.com[0][k] + com_offset[k] : K.com[b][k];
      qapply(qb, cl, v);
      for (int k = 0; k < 3; ++k) cr[k] = V.pos_rel[b][k] + v[k];
      float bm[3][3], iw[3][3];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c)
          bm[a][c] = r[a][0] * K.inertia[b][0][c] + r[a][1] * K.inertia[b][1][c] +
                     r[a][2] * K.inertia[b][2][c];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c)
          iw[a][c] = bm[a][0] * r[c][0] + bm[a][1] * r[c][1] + bm[a][2] * r[c][2];
      const float c2 = dot3(cr, cr);
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c)
          V.u.d.io[b][3 * a + c] = iw[a][c] + m_b * ((a == c ? c2 : 0.0f) - cr[a] * cr[c]);
      for (int k = 0; k < 3; ++k) V.u.d.h[b][k] = cr[k] * m_b;
      float gz = (b == 0) ? m_b * K.grav * K.gscale : K.grav_z[b];
      float gl[3] = {0.0f, 0.0f, gz};
      float c[3];
      cross3(cr, gl, c);
      for (int k = 0; k < 3; ++k) {
        V.u.d.e_ang[b][k] = c[k] + ea[k];
        V.u.d.e_lin[b][k] = gl[k] + el[k];
      }
      if (b == 0) {
        for (int k = 0; k < 6; ++k) V.u.d.bias[0][k] = 0.0f;
      } else {
        const float qdi = qd[b - 1];
        float sqd[6], ca[3], c1[3], c2v[3];
        for (int k = 0; k < 6; ++k) sqd[k] = V.sub[b][k] * qdi;
        cross3(&V.tw[b][0], &sqd[0], ca);
        cross3(&V.tw[b][0], &sqd[3], c1);
        cross3(&V.tw[b][3], &sqd[0], c2v);
        for (int k = 0; k < 3; ++k) {
          V.u.d.bias[b][k] = ca[k];
          V.u.d.bias[b][3 + k] = c1[k] + c2v[k];
        }
      }
    }
    __syncwarp(mask);
    // bias accelerations down the tree: one lane per component walks the
    // bodies in index order (each parent before its children, as in fk);
    // the value just written is kept in a register for its first child
    for (int k = l; k < 6; k += T) {
      float last = 0.0f;
      int last_i = -1;
      for (int i = 1; i < NB; ++i) {
        const int p = K.parent[i];
        const float v = (p == last_i ? last : V.u.d.bias[p][k]) + V.u.d.bias[i][k];
        V.u.d.bias[i][k] = v;
        last = v;
        last_i = i;
      }
    }
    __syncwarp(mask);

    // body forces, per body lane
    for (int b = l; b < NB; b += T) {
      const float m_b = (b == 0) ? K.mass[0] * mass_scale : K.mass[b];
      const float* w = &V.tw[b][0];
      const float* v = &V.tw[b][3];
      const float* ba_w = &V.u.d.bias[b][0];
      const float* ba_v = &V.u.d.bias[b][3];
      const float* hb = V.u.d.h[b];
      float t0[3], t1[3], l_mom[3], p_mom[3], ia_ang[3], ia_lin[3], c1[3], c2[3];
      m3vec9(V.u.d.io[b], w, t0);
      cross3(hb, v, t1);
      for (int k = 0; k < 3; ++k) l_mom[k] = t0[k] + t1[k];
      cross3(w, hb, t1);
      for (int k = 0; k < 3; ++k) p_mom[k] = v[k] * m_b + t1[k];
      m3vec9(V.u.d.io[b], ba_w, t0);
      cross3(hb, ba_v, t1);
      for (int k = 0; k < 3; ++k) ia_ang[k] = t0[k] + t1[k];
      cross3(ba_w, hb, t1);
      for (int k = 0; k < 3; ++k) ia_lin[k] = ba_v[k] * m_b + t1[k];
      cross3(w, l_mom, c1);
      cross3(v, p_mom, c2);
      for (int k = 0; k < 3; ++k) V.u.d.f_acc[b][k] = (ia_ang[k] + (c1[k] + c2[k])) - V.u.d.e_ang[b][k];
      cross3(w, p_mom, c1);
      for (int k = 0; k < 3; ++k) V.u.d.f_acc[b][3 + k] = (ia_lin[k] + c1[k]) - V.u.d.e_lin[b][k];
    }
    __syncwarp(mask);

    // the RNEA sums to the root and the CRBA composite sums, one lane per
    // component (6 of f_acc, 3 of h, 9 of io), each in the serial order of
    // the bodies; the entry written last stays in a register for the next
    // step that reads it. Every lane folds the root's composite mass.
    float cm0 = K.mass[0] * mass_scale;
    {
      constexpr int NCH = 18, RND = (NCH + T - 1) / T;
      float* col[RND];
      int stride[RND], last_i[RND];
      float last[RND];
#pragma unroll
      for (int rr = 0; rr < RND; ++rr) {
        const int c = l + rr * T;
        col[rr] = c < 6 ? &V.u.d.f_acc[0][c] : c < 9 ? &V.u.d.h[0][c - 6] : &V.u.d.io[0][c < NCH ? c - 9 : 0];
        stride[rr] = c < 6 ? 7 : c < 9 ? 3 : 9;
        last_i[rr] = -1;
        last[rr] = 0.0f;
      }
      for (int i = NB - 1; i > 0; --i) {
        const int p = K.parent[i];
        if (p == 0) cm0 = cm0 + K.cm_sub[i];
#pragma unroll
        for (int rr = 0; rr < RND; ++rr) {
          if (l + rr * T < NCH) {
            float* cc = col[rr];
            const float vi = i == last_i[rr] ? last[rr] : cc[i * stride[rr]];
            const float vp = p == last_i[rr] ? last[rr] : cc[p * stride[rr]];
            const float v = vp + vi;
            cc[p * stride[rr]] = v;
            last[rr] = v;
            last_i[rr] = p;
          }
        }
      }
    }
    __syncwarp(mask);

    // right-hand side and the composite-inertia columns, per dof lane
    for (int k = l; k < 6; k += T) V.yacc[k] = -V.u.d.f_acc[0][k];
    for (int j = l; j < ND; j += T) {
      const int b = j + 1;
      float sacc = 0.0f;
      for (int k = 0; k < 6; ++k) sacc = sacc + V.sub[b][k] * V.u.d.f_acc[b][k];
      V.yacc[6 + j] = V.tau[j] - sacc;
      const float* sw = &V.sub[b][0];
      const float* sv = &V.sub[b][3];
      const float* hb = V.u.d.h[b];
      float t0[3], t1[3];
      m3vec9(V.u.d.io[b], sw, t0);
      cross3(hb, sv, t1);
      for (int k = 0; k < 3; ++k) V.u.d.f_crb[j][k] = t0[k] + t1[k];
      cross3(sw, hb, t1);
      for (int k = 0; k < 3; ++k) V.u.d.f_crb[j][3 + k] = sv[k] * K.cm_sub[b] + t1[k];
    }
    __syncwarp(mask);

    // The lower triangle of M + ridge, and its Cholesky factorisation with
    // the forward substitution folded in. Lane l holds row l (l < NO: the
    // team's width, or N6 where that is less) in registers, columns 0 to
    // NO - 1 (row[k] = L(l, k)). The NX rows past them are held by column:
    // lane l holds their entries in column l (xb[m] = L(NO + m, l)) and in
    // column NO + l (xc[m] = L(NO + m, NO + l)), and row NO + l's right-hand
    // side. Another lane's entry is read by shuffle. At column j every lane
    // takes d and 1/d from the column's diagonal, scales the column's entries
    // (raw times 1/d, as the serial loop does) and updates its entries L(i, k)
    // for j < k by L(i, j) L(k, j): each entry sees the same subtractions, of
    // the same products, in the same order as in the serial loops. Entries
    // above the diagonal (k > i) are updated too but never read. The factor
    // goes to Ls for the back substitution.
    {
      constexpr int NO = N6 < T ? N6 : T, NX = N6 - NO;
      static_assert(NX <= T, "the rows past the team's width are held one column a lane");
      float row[NO], yacc, xb[cap(NX)], xc[cap(NX)], yx = 0.0f;
      // each entry as in the serial fill, by selects (every lane runs every
      // row kind's code for its own row, clamped, and keeps its own kind's)
      const float* ch0 = V.u.d.h[0];
      {
        const int i = l;
        const int i3 = i < 3 ? i : 2, ii = i < 3 ? 0 : i < 6 ? i - 3 : 2;
        const int jr = i < 6 ? 0 : i < N6 ? i - 6 : ND - 1;  // this row's dof
        float fc[6];
        for (int k = 0; k < 6; ++k) fc[k] = V.u.d.f_crb[jr][k];
        const unsigned anc = K.anc_mask[jr];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          float v;
          if (j < 3) {
            const float nh = j == 0 ? (ii == 0 ? -0.0f : ii == 1 ? -ch0[2] : ch0[1])
                           : j == 1 ? (ii == 0 ? ch0[2] : ii == 1 ? -0.0f : -ch0[0])
                                    : (ii == 0 ? -ch0[1] : ii == 1 ? ch0[0] : -0.0f);
            v = i < 3 ? V.u.d.io[0][3 * i3 + j] : i < 6 ? nh : fc[j];
          } else if (j < 6) {
            v = i < 6 ? (ii == j - 3 ? cm0 : 0.0f) + 0.0f : fc[j];
          } else {
            v = dof_entry<S>(K, jr, anc, fc, V.sub[j - 5], j - 6, dt * V.damp[jr]);
          }
          if (i == j) v = v + 1e-6f;
          row[j] = (i < N6 && j <= i) ? v : 0.0f;
        }
        yacc = i < N6 ? V.yacc[i] : 0.0f;
      }
      if constexpr (NX > 0) {
        // rows NO + m, dof rows (NO >= 8): lane l fills their entries in
        // columns l and NO + l (none past the last column)
        const int jc = NO + (l < NX ? l : 0);
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          const int jr = NO + m - 6;
          const float* fc = V.u.d.f_crb[jr];
          const unsigned anc = K.anc_mask[jr];
          const float dd = dt * V.damp[jr];
          float vb = l < 6 ? fc[l] : dof_entry<S>(K, jr, anc, fc, V.sub[l < 6 ? 1 : l - 5], l - 6, dd);
          float vc = dof_entry<S>(K, jr, anc, fc, V.sub[jc - 5], jc - 6, dd);
          if (NO + m == jc) vc = vc + 1e-6f;
          xb[m] = vb;
          xc[m] = (l < NX && jc <= NO + m) ? vc : 0.0f;
        }
        yx = l < NX ? V.yacc[NO + l] : 0.0f;
      }
      if constexpr (TeamEnv<S>::SHARED_LS) {
        // the factor overwrites the dynamics arrays the fill has read
        __syncwarp(mask);
      }
#pragma unroll
      for (int j = 0; j < N6; ++j) {
        if (j < NO) {
          const float d = sqrtf(nmax(__shfl_sync(mask, row[j], j, T), 1e-12f));
          const float inv_d = 1.0f / d;
          const float yj = __shfl_sync(mask, yacc, j, T) / d;
          const float lij = row[j] * inv_d;
          // L(NO + m, j), from lane j; lane l < NX keeps L(NO + l, j)
          float lx[cap(NX)];
#pragma unroll
          for (int m = 0; m < NX; ++m) lx[m] = __shfl_sync(mask, xb[m], j, T) * inv_d;
          const float lxl = pick<NX>(lx, l);
          // L(k, j) is lane k's own scaled entry
#pragma unroll
          for (int k = j + 1; k < NO; ++k) {
            const float lkj = __shfl_sync(mask, lij, k, T);
            row[k] = row[k] - lij * lkj;
          }
#pragma unroll
          for (int m = 0; m < NX; ++m) {
            xb[m] = xb[m] - lx[m] * lij;
            xc[m] = xc[m] - lx[m] * lxl;
          }
          if (l == j) {
            TLS(j, j) = d;
            V.y[j] = yj;
          } else if (l > j && l < NO) {
            TLS(l, j) = lij;
            yacc = yacc - lij * yj;
          }
          if (l < NX) {
            TLS(NO + l, j) = lxl;
            yx = yx - lxl * yj;
          }
        } else {
          // column NO + p: its entries are lane p's
          const int p = j - NO;
          const float d = sqrtf(nmax(__shfl_sync(mask, xc[p], p, T), 1e-12f));
          const float inv_d = 1.0f / d;
          const float yj = __shfl_sync(mask, yx, p, T) / d;
          float lc[cap(NX)];
#pragma unroll
          for (int m = 0; m < NX; ++m) lc[m] = m > p ? __shfl_sync(mask, xc[m], p, T) * inv_d : 0.0f;
          const float lcl = pick<NX>(lc, l);
#pragma unroll
          for (int m = p + 1; m < NX; ++m) xc[m] = xc[m] - lc[m] * lcl;
          if (l == p) {
            TLS(j, j) = d;
            V.y[j] = yj;
          } else if (l > p && l < NX) {
            TLS(NO + l, j) = lcl;
            yx = yx - lcl * yj;
          }
        }
      }
    }
    __syncwarp(mask);
    // back substitution on one lane
    if (l == 0) {
      float x[N6];
#pragma unroll
      for (int i = N6 - 1; i >= 0; --i) {
        float acc = V.y[i];
#pragma unroll
        for (int j = i + 1; j < N6; ++j) acc = acc - TLS(j, i) * x[j];
        x[i] = acc / TLS(i, i);
      }
#pragma unroll
      for (int i = 0; i < N6; ++i) V.x[i] = x[i];
    }
    __syncwarp(mask);

    // semi-implicit Euler: the base on lane 0, the joints per dof lane
    if (l == 0) {
      const float* x = V.x;
      float angn[3], linn[3], lin_acc[3], c[3];
      for (int k = 0; k < 3; ++k) angn[k] = clipf(ang[k] + x[k] * dt, -100.0f, 100.0f);
      cross3(ang, lin, c);
      for (int k = 0; k < 3; ++k) lin_acc[k] = x[3 + k] + c[k];
      for (int k = 0; k < 3; ++k) linn[k] = clipf(lin[k] + lin_acc[k] * dt, -100.0f, 100.0f);
      for (int k = 0; k < 3; ++k) pos[k] = pos[k] + linn[k] * dt;
      float angle = sqrtf(nmax(dot3(angn, angn), 0.0f));
      float inv = 1.0f / nmax(angle, 1e-9f);
      float axis[3] = {angn[0] * inv, angn[1] * inv, angn[2] * inv};
      float dq[4], qn4[4];
      q_from_angle_axis(angle * dt, axis, dq);
      qmul(dq, quat, qn4);
      float qn = sqrtf(nmax(qn4[0] * qn4[0] + qn4[1] * qn4[1] + qn4[2] * qn4[2] +
                                qn4[3] * qn4[3],
                            0.0f));
      float qs = 1.0f / nmax(qn, 1e-9f);
      for (int k = 0; k < 4; ++k) quat[k] = qn4[k] * qs;
      for (int k = 0; k < 3; ++k) { ang[k] = angn[k]; lin[k] = linn[k]; }
    }
    for (int i = l; i < ND; i += T) {
      qd[i] = clipf(qd[i] + V.x[6 + i] * dt, -100.0f, 100.0f);
      q[i] = q[i] + qd[i] * dt;
    }

    // feet accumulators, per foot lane (pre-step kinematics, final forces)
    for (int g = l; g < NF; g += T) {
      const int p0 = K.feet_start[g], cnt = K.feet_count[g];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      for (int m = 0; m < cnt; ++m) {
        const int p = K.feet_pts[p0 + m];
        fx = fx + V.forces[p][0];
        fy = fy + V.forces[p][1];
        fz = fz + V.forces[p][2];
      }
      V.force_sum[g] = V.force_sum[g] + sqrtf(fx * fx + fy * fy + fz * fz);
      const int b = K.feet_body[g];
      float c[3];
      cross3(&V.tw[b][0], V.pos_rel[b], c);
      for (int k = 0; k < 3; ++k) {
        V.vxyz[g][k] = V.vxyz[g][k] + fabsf(V.tw[b][3 + k] + c[k]);
        V.vrpy[g][k] = V.vrpy[g][k] + fabsf(V.tw[b][k]);
      }
    }
    __syncwarp(mask);
  }

  // final-state FK of the post bodies
  team_fk<S, T>(K, V, quat, ang, lin, q, qd, l, mask);

  // ---- post-physics stage (LanePost.run): the env's scalars on lane 0 ----
  const float* const cmd = V.in + K.in_off[IN_COMMANDS];
  const float* const lla = V.in + K.in_off[IN_LAST_LAST_ACTIONS];
  PostVals<S>& P = V.post;
  if constexpr (FOLD) {
    if (l == 0)
      post_values<S>(K, P, pos, quat, lin, ang, q, qd, V.quats, V.pos_rel, V.forces,
                     V.in + K.in_off[IN_FEET_CONTACT_LAST], V.in + K.in_off[IN_FEET_AIR_TIME],
                     V.in + K.in_off[IN_FEET_LAND_TIME], cmd);
    __syncwarp(mask);
  }

  // ---- outputs, staged per env, then stored by the block per component row ----
  float* const ob = V.u.outb;
  auto put = [&](int group, int k, float v) { ob[K.out_off[group] + k] = v; };
  for (int k = l; k < 3; k += T) { put(OUT_POS, k, pos[k]); put(OUT_LIN, k, lin[k]); put(OUT_ANG, k, ang[k]); }
  for (int k = l; k < 4; k += T) put(OUT_QUAT, k, quat[k]);
  for (int i = l; i < ND; i += T) { put(OUT_Q, i, q[i]); put(OUT_QD, i, qd[i]); put(OUT_TAU, i, V.taus[i]); }
  for (int c = l; c < 3 * NP; c += T) {
    put(OUT_ANCHOR, c, anchor[c]);
    put(OUT_POINT_FORCE, c, V.forces[c / 3][c % 3]);
  }
  for (int f = l; f < NF; f += T) {
    put(OUT_FORCE_SUM, f, V.force_sum[f]);
    for (int k = 0; k < 3; ++k) {
      put(OUT_VXYZ_SUM, 3 * f + k, V.vxyz[f][k]);
      put(OUT_VRPY_SUM, 3 * f + k, V.vrpy[f][k]);
    }
  }
  for (int c = l; c < 4 * S::NPOST; c += T) put(OUT_POST_QUAT, c, V.quats[K.post_body[c / 4]][c % 4]);
  for (int c = l; c < 3 * S::NPOST; c += T) put(OUT_POST_REL, c, V.pos_rel[K.post_body[c / 3]][c % 3] + 0.0f);
  // final-state world positions of the contact points, per point lane (terrain modes)
  if constexpr (TERRAIN != 0) {
    for (int p = l; p < NP; p += T) {
      const int b = K.point_body[p];
      float v[3];
      qapply(V.quats[b], K.point_offset[p], v);
      for (int k = 0; k < 3; ++k) put(OUT_POINT_POS, 3 * p + k, pos[k] + (V.pos_rel[b][k] + v[k]));
    }
  }
  if constexpr (FOLD) {
    const RewardIn<S> R{K, P, actions, last_actions, lla, q, qd, last_qd, cmd, V.taus, V.force_sum, pos,
                        V.vxyz};
    for (int r = l; r < S::NR; r += T) put(OUT_REW_TERMS, r, reward_term<S>(r, R));
    for (int k = l; k < 3; k += T) { put(OUT_BLV, k, P.blv[k]); put(OUT_BAV, k, P.bav[k]); put(OUT_PG, k, P.pg[k]); }
    for (int f = l; f < NF; f += T) {
      put(OUT_FEET_CONTACT, f, b2f(P.feet_contact[f]));
      put(OUT_CONTACT_FILT, f, b2f(P.contact_filt[f]));
      put(OUT_FIRST_CONTACT, f, P.first_contact[f]);
      put(OUT_FEET_AIR_TIME, f, P.fat[f]);
      put(OUT_FEET_LAND_TIME, f, P.flt[f]);
      put(OUT_FEET_HEIGHT, f, P.feet_height[f]);
    }
    if (l == 0) {
      put(OUT_TERM_CONTACT, 0, b2f(P.term));
      put(OUT_TILT, 0, b2f(P.tilt));
      put(OUT_BAD, 0, b2f(!P.fin));
      put(OUT_BHO, 0, P.bho);
    }
  }
#undef TLS
  __syncthreads();
  for (int idx = tid; idx < S::NOUT * E; idx += NT) {
    const int c = idx / E, j = idx % E;
    if (e0 + j < n) out[(size_t)c * n + e0 + j] = envs[j].u.outb[c];
  }
}

}  // namespace
}  // namespace k1

// The host side: the C interface and the launches. The host-compiled copy
// of the kernels (csrc/host/k1_host.cpp) defines K1_KERNELS_ONLY and brings
// its own.
#ifndef K1_KERNELS_ONLY

extern "C" {

int k1_const_size() { return (int)sizeof(k1::ModelConst<k1::Sz>); }

// Copies the model constants into __constant__ memory, ordered on `stream`.
int k1_set_constants(const void* host, int nbytes, void* stream) {
  if (nbytes != (int)sizeof(k1::ModelConst<k1::Sz>)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbolAsync(k1::c_model, host, nbytes, 0,
                                            cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(k1::g_model, host, nbytes, 0, cudaMemcpyHostToDevice,
                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // the host struct may be reused or freed by the caller right after
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

}  // extern "C"

namespace k1 {
namespace {

static_assert(team_smem_bytes<Sz, TEAM_E>() <= 232448, "the team shape's shared memory exceeds a block's 227 KB");
static_assert(team_min_blocks<Sz, TEAM_T, TEAM_E>() >= 1, "no block of this team shape fits an SM");

struct TeamSetup {
  cudaError_t err;
  const ModelConst<Sz>* model;  // device address of g_model
  void* const_model;            // device address of c_model
};

// Done once, at the first launch (never inside a graph's capture): allow the
// dynamic shared memory above 48 KB, find the constants' device addresses.
const TeamSetup& team_setup() {
  static const TeamSetup s = [] {
    TeamSetup r{cudaSuccess, nullptr, nullptr};
    r.err = cudaFuncSetAttribute(decimation_team_kernel<Sz, TEAM_T, TEAM_E>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, team_smem_bytes<Sz, TEAM_E>());
    if (r.err == cudaSuccess) r.err = cudaGetSymbolAddress((void**)&r.model, g_model);
    if (r.err == cudaSuccess) r.err = cudaGetSymbolAddress(&r.const_model, c_model);
    return r;
  }();
  return s;
}

}  // namespace

}  // namespace k1

extern "C" {

// in: (C_in, n) float32, out: (C_out, n) float32, both contiguous on the
// device. The main path's kernel.
int k1_launch(const float* in, float* out, int n, void* stream) {
  using namespace k1;
  if (n <= 0) return (int)cudaSuccess;
  const TeamSetup& s = team_setup();
  if (s.err != cudaSuccess) return (int)s.err;
  decimation_team_kernel<Sz, TEAM_T, TEAM_E>
      <<<(n + TEAM_E - 1) / TEAM_E, TEAM_T * TEAM_E, team_smem_bytes<Sz, TEAM_E>(), (cudaStream_t)stream>>>(
          s.model, in, out, n);
  return (int)cudaGetLastError();
}

// The copy of k1_set_constants from a device-resident copy of the struct,
// ordered on `stream`, with no synchronize and no other runtime call: a CUDA
// graph captures it as two memcpy nodes, so each replay puts its own
// constants in place before its launches. The symbols' addresses come from
// the first launch (team_setup).
int k1_copy_constants(const void* device_src, int nbytes, void* stream) {
  using namespace k1;
  if (nbytes != (int)sizeof(ModelConst<Sz>)) return (int)cudaErrorInvalidValue;
  const TeamSetup& s = team_setup();
  if (s.err != cudaSuccess) return (int)s.err;
  cudaError_t err = cudaMemcpyAsync(s.const_model, device_src, nbytes, cudaMemcpyDeviceToDevice,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync((void*)s.model, device_src, nbytes, cudaMemcpyDeviceToDevice,
                              (cudaStream_t)stream);
}

// The one-thread-per-env kernel, kept as the team kernel's bit-for-bit
// reference (chip_smoke.py phase 3, tests/test_torch_decimation_cuda.py).
int k1_launch_thread(const float* in, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + k1::THREADS - 1) / k1::THREADS;
  k1::decimation_kernel<k1::Sz><<<blocks, k1::THREADS, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// The team kernel's lanes per env, envs per block, dynamic shared memory per
// block and resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int k1_occupancy(int* threads_per_env, int* envs_per_block, int* smem_bytes, int* blocks_per_sm) {
  using namespace k1;
  const TeamSetup& s = team_setup();
  if (s.err != cudaSuccess) return (int)s.err;
  *threads_per_env = TEAM_T;
  *envs_per_block = TEAM_E;
  *smem_bytes = team_smem_bytes<Sz, TEAM_E>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, decimation_team_kernel<Sz, TEAM_T, TEAM_E>, TEAM_T * TEAM_E, *smem_bytes);
}

}  // extern "C"

#endif  // K1_KERNELS_ONLY
