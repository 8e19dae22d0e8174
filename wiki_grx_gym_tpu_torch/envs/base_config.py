"""Nested-class config system + base legged-robot config.

Mirrors the reference's inheritance-based config trees
(`legged_gym/envs/base/base_config.py:33-55` — recursive auto-instantiation
of nested classes) so that robot variants are plain subclasses overriding a
handful of attributes (the 5-level chain `LeggedRobotCfg -> FFTAI -> GR1T1 ->
GR1T1LowerLimb -> GR1T2LowerLimb`, SURVEY.md §5).

Default values below follow `legged_gym/envs/base/legged_robot_config.py`.
"""

from __future__ import annotations

import inspect


class BaseConfig:
    """Recursively instantiates nested config classes on construction so
    instances can be mutated per-run (CLI overrides) without touching the
    class definitions."""

    def __init__(self):
        self._init_member_classes(self)

    @staticmethod
    def _init_member_classes(obj):
        for key in dir(obj):
            if key.startswith("__"):
                continue
            var = getattr(obj, key)
            if inspect.isclass(var):
                inst = var()
                setattr(obj, key, inst)
                BaseConfig._init_member_classes(inst)


def class_to_dict(obj) -> dict:
    """Config (sub)tree -> plain dict (`legged_gym/utils/helpers.py:42-57`)."""
    if not hasattr(obj, "__dict__") and not hasattr(obj, "__class__"):
        return obj
    result = {}
    for key in dir(obj):
        if key.startswith("_"):
            continue
        val = getattr(obj, key)
        if callable(val) and not inspect.isclass(val):
            continue
        if hasattr(val, "__dict__") or inspect.isclass(val):
            result[key] = class_to_dict(val)
        else:
            result[key] = val
    return result


def update_class_from_dict(obj, d: dict) -> None:
    """dict -> config tree, recursively (`legged_gym/utils/helpers.py:60-67`)."""
    for key, val in d.items():
        attr = getattr(obj, key, None)
        if isinstance(val, dict):
            update_class_from_dict(attr, val)
        else:
            setattr(obj, key, val)


class LeggedRobotCfg(BaseConfig):
    class sim:
        dt = 0.005
        gravity = [0.0, 0.0, -9.81]
        # contact solver constants (replace the reference's PhysX block,
        # legged_robot_config.py:41-52, with penalty-contact knobs)
        contact_stiffness = 1.0e4       # N/m per proxy sphere
        contact_damping_ratio = 0.7
        contact_point_mass = 0.25       # kg; caps damping/friction impulses
        slip_velocity = 1e-5
        contact_tangent_stiffness = 1.0e4  # anchored stick friction; 0 = viscous
        # URDF joint-limit enforcement (PhysX does this as hard constraints):
        # max limit violation in rad when driven at full effort; 0 disables
        joint_limit_violation = 0.05
        # solve the PD drive's damping term implicitly — (M + dt*D) qdd = tau
        # — mirroring PhysX's implicit joint drives; required for stability
        # on small-inertia joints (full-body wrists: kd*dt/M ~ 200)
        implicit_pd_damping = True
        # sphere-sphere self-collision spring (stiffer than the ground so
        # driven limb-limb contact stays under ~5 mm penetration)
        contact_self_collision_stiffness = 1.0e5
        # physics backend (envs/legged_env.physics_backend): "auto" = K1
        # (sim/cuda_step.py) on CUDA, its lane program on the CPU; True/"on"
        # = K1 (raises on the CPU); False/"off" = the batched engine
        # (sim/engine.py) on either device; "lanes"/"interpret" = the lane
        # program (K1's plain version) on either device
        use_pallas = "auto"
        # kernel substep loop: "unroll" (decimation copies of the substep
        # program), "fori" (one copy in a lax.fori_loop — ~10x smaller
        # program), or "auto". Measured on v5e at 4096 envs (.tpujobs/j12):
        # identical runtime (83.88 vs 83.93 ms/iter), cold Mosaic compile
        # 62 s vs ~6 min. But the fori carry lives on the kernel's VMEM
        # stack, and the 32-DOF full-body model exceeds the 16 MB scoped
        # limit (j22) — "auto" picks fori for models with <= 16 DOFs,
        # unroll otherwise
        kernel_loop = "auto"

    class env:
        num_envs = 4096
        episode_length_s = 20
        num_obs = 235
        num_pri_obs = None
        num_actions = 12
        env_spacing = 3.0
        send_timeouts = True

    class terrain:
        mesh_type = "trimesh"  # none, plane, heightfield, trimesh
        horizontal_scale = 0.1
        vertical_scale = 0.005
        border_size = 25
        curriculum = True
        num_rows = 10
        num_cols = 20
        max_init_terrain_level = 9
        static_friction = 1.0
        dynamic_friction = 1.0
        restitution = 0.0
        measure_heights = True
        # terrain-sample refresh period in policy steps: k > 1 resamples
        # the per-point contact ground planes and the measured height grid
        # every k-th step and carries them in between (base travel is
        # <= ~2 cm/step, bounding the staleness; just-reset envs get a
        # flat spawn-origin plane until the next refresh). 1 = the
        # reference's every-step sampling (legged_robot.py:329-330).
        # Default 2: heightfield/trimesh training at k=2 matched or beat
        # the k=1 tracking tables on every command (docs/TRAINING.md r5;
        # trimesh wz 76.6 -> 97.2%) at +35-55% terrain throughput
        # (.tpujobs/r5o2: trimesh 1.01M -> 1.54M env-steps/s @4096)
        refresh_interval = 2
        measured_points_x = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
        measured_points_y = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
        selected = False
        terrain_kwargs = None
        terrain_proportions = [0.1, 0.1, 0.35, 0.25, 0.2]
        slope_treshold = 0.75
        terrain_length = 8.0
        terrain_width = 8.0

    class asset:
        file = ""
        name = "legged_robot"
        torso_name = "torso"
        foot_name = "None"
        penalize_contacts_on = []
        terminate_after_contacts_on = ["base"]
        disable_gravity = False
        fix_base_link = False
        self_collisions = 0
        armature = 0.0

    class init_state:
        pos = [0.0, 0.0, 1.0]
        rot = [0.0, 0.0, 0.0, 1.0]
        lin_vel = [0.0, 0.0, 0.0]
        ang_vel = [0.0, 0.0, 0.0]
        default_joint_angles = {"joint_a": 0.0, "joint_b": 0.0}

    class commands:
        curriculum = False
        max_curriculum = 1.0
        num_commands = 4
        resampling_command_interval_s = 10.0
        heading_command = True

        class ranges:
            lin_vel_x = [-1.0, 1.0]
            lin_vel_y = [-1.0, 1.0]
            ang_vel_yaw = [-1.0, 1.0]
            heading = [-3.14, 3.14]

    class control:
        control_type = "P"  # P: position, V: velocity, T: torques
        stiffness = {"joint_a": 10.0, "joint_b": 15.0}
        damping = {"joint_a": 1.0, "joint_b": 1.5}
        action_scale = 0.5
        decimation = 4
        # actuation delay model (legged_robot_fftai.py:53-54): per-env normal
        # in substeps; the reference samples one host-side value per step,
        # here it is per-env and traced
        actuation_delay = False
        actuation_delay_mean = 5.0
        actuation_delay_std = 2.0

    class domain_rand:
        # per-property sampling distribution: "uniform", "loguniform", or
        # "gaussian" (range read as (mu, var)) — the gymutil DR sampler
        # modes (gymutil.py:521-583). The GRx configs use uniform.
        randomize_friction = True
        friction_range = [0.1, 1.0]
        friction_distribution = "uniform"
        # bucketed sampling as `_process_rigid_shape_props`
        # (legged_robot.py:550-563): draw num_buckets values, assign envs to
        # buckets (PhysX materials are per-shape; bucketing bounds their
        # count). 0 = continuous per-env sampling (no bucketing).
        friction_buckets = 64
        randomize_restitution = True
        restitution_range = [0.0, 0.5]
        restitution_distribution = "uniform"
        restitution_buckets = 64
        randomize_base_mass = True
        multiply_base_mass_range = [0.9, 1.1]
        base_mass_distribution = "uniform"
        randomize_base_com = True
        add_base_com_range_x = [-0.1, 0.1]
        add_base_com_range_y = [-0.1, 0.1]
        add_base_com_range_z = [-0.1, 0.1]
        randomize_motor_strength = True
        multiply_motor_strength = [0.9, 1.1]
        motor_strength_distribution = "uniform"
        push_robots = True
        push_interval_s = 10.0
        max_push_vel_xy = 0.5
        randomize_init_dof_pos = True
        randomize_init_base_velocity = True

    class rewards:
        class scales:
            termination = -0.0

        only_positive_rewards = True
        tracking_sigma = 0.25
        soft_dof_pos_limit = 1.0
        soft_dof_vel_limit = 1.0
        soft_torque_limit = 1.0
        base_height_target = 1.0
        max_contact_force = 100.0
        # exp sharpness for the limits_actions term; the reference reads it
        # (legged_robot_fftai.py:317) but never defines it in any config —
        # a usable default completes the dormant API
        sigma_limits_actions = -1.0

    class noise:
        add_noise = True
        noise_level = 1.0

        class noise_scales:
            action = 0.0
            dof_pos = 0.01
            dof_vel = 1.5
            lin_vel = 0.1
            ang_vel = 0.2
            gravity = 0.05
            height_measurements = 0.1

    class normalization:
        class obs_scales:
            action = 1.0
            lin_vel = 2.0
            ang_vel = 0.25
            gravity = 1.0
            dof_pos = 1.0
            dof_vel = 0.05
            height_measurements = 5.0

        clip_observations = 100.0
        clip_actions = 100.0

    class viewer:
        ref_env = 0
        pos = [10, 0, 6]
        lookat = [11.0, 5, 3.0]


class LeggedRobotCfgPPO(BaseConfig):
    seed = 1
    runner_class_name = "OnPolicyRunner"

    class runner:
        algorithm_class_name = "PPO"
        policy_class_name = "ActorCritic"
        num_steps_per_env = 24
        max_iterations = 1500
        save_interval = 50
        experiment_name = "test"
        run_name = ""
        resume = False
        load_run = -1
        checkpoint = -1
        resume_path = None

    class algorithm:
        value_loss_coef = 1.0
        use_clipped_value_loss = True
        clip_param = 0.2
        entropy_coef = 0.01
        num_learning_epochs = 5
        num_mini_batches = 4
        learning_rate = 1.0e-3
        learning_rate_min = 1.0e-5
        learning_rate_max = 1.0e-2
        schedule = "adaptive"
        gamma = 0.99
        lam = 0.95
        desired_kl = 0.01
        max_grad_norm = 1.0
        storage_class = "RolloutStorage"
        # mirror-symmetry loss weight (rsl_rl ppo.py:96 scaffolding,
        # completed in learn/symmetry.py); 0 disables the term
        symmetry_coef = 0.0
        # minibatch-shuffle locality groups; 0 = auto (dp mesh size), so the
        # PPO update performs zero cross-device gathers (learn/ppo.py)
        permutation_groups = 0
        # shuffle granularity: blocks of this many consecutive envs at one
        # timestep move as one contiguous row; 1 = the reference's exact
        # per-sample shuffle (base_storage.py:169), 16 = TPU-friendly DMA
        shuffle_block = 16
        # storage dtype of the packed obs/critic_obs shuffle buffer in the
        # PPO update ("bfloat16" or "float32"); ratio/KL-critical fields are
        # always float32 (learn/ppo.py)
        storage_dtype = "bfloat16"
        # update-phase MLP activation dtype ("float32" or "bfloat16");
        # scoped to the PPO grad steps only (learn/ppo.py). f32 (the
        # reference's dtype throughout) measured FASTER than bf16 at both
        # batch sizes on v5e (3.34M vs 3.28M env-steps/s @4096, 3.50M vs
        # 3.44M @8192, r4 .tpujobs/j28 — the per-layer casts cost more
        # than the halved activation traffic saves)
        update_dtype = "float32"
        # run actor mean + critic value as ONE stacked batched-matmul trunk
        # (networks.joint_mean_value) in the rollout and the update grad
        # steps; False = separate actor/critic stacks, the reference's
        # layout (actor_critic_mlp.py:59-74). Default OFF: the stacked
        # trunk measured +16 ms/iteration in the PPO update at 4096 envs
        # (v5e A/B, tools/jobs/r4_job01_ab.py — the jnp.stack of the two
        # hidden activations is an extra HBM round trip per layer that
        # outweighs the halved dispatch count)
        fused_trunk = False
        # pre-pack obs||critic_obs into the update's storage-dtype shuffle
        # buffer inside the rollout scan (learn/runner._rollout) instead of
        # a separate concat pass in the update (learn/ppo._pack_shuffle)
        pack_rollout = True
        # each PPO grad step as ONE Pallas kernel — both MLP forwards, the
        # clipped-PPO loss and the hand-derived backward fused, with weights
        # and grad accumulators VMEM-resident (learn/fused_update.py).
        # "auto" = on for single-device TPU on the supported path (MLP +
        # elu + no extra loss term); True forces it (interpreter off-TPU,
        # for tests); False = the plain XLA scan path
        fused_update = "auto"
        # batch-tile rows per kernel grid step on the fused path
        fused_update_tile = 512
        # fused path form: True = the ENTIRE update (grad steps + clip +
        # Adam + adaptive LR) as ONE kernel with params/moments persistent
        # in VMEM; False = per-grad-step kernel + flat optax clip/Adam
        fused_mega = True

    class policy:
        init_noise_std = 1.0
        fixed_std = False
        # exploration floor for the learnable per-dim std: after every
        # optimizer step params.std is projected to max(std, floor)
        # (projected gradient — the std still receives gradients at the
        # boundary). 0 disables (the reference's unconstrained std,
        # actor_critic_mlp.py:82-83). Used by tasks where the annealed std
        # stops exploration before tracking converges (GR1T1_full).
        noise_std_floor = 0.0
        actor_hidden_dims = [512, 256, 128]
        critic_hidden_dims = [512, 256, 128]
        activation = "elu"
        actor_output_activation = None
        critic_output_activation = None
        # recurrent policy (learn/recurrent.py; upstream rsl_rl knob names):
        # rnn_type "lstm" switches runner+PPO to the trajectory-aware path
        rnn_type = None
        rnn_hidden_size = 256
        rnn_num_layers = 1
        # "bfloat16" runs the actor/critic matmuls in bf16 on the MXU
        # (params/optimizer/distribution math stay f32). The reference has
        # no equivalent knob (f32 throughout); see docs/TRAINING.md for the
        # learning-parity validation before enabling in a shipped config.
        compute_dtype = "float32"
