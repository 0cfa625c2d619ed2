"""Hermetic smoke-run config on the synthetic sphere dataset (no downloads)."""
config = [
    # fmt: off
    "--train", "true",
    "--evaluate", "false",

    "--model.log2_hashmap_size", "14",
    "--model.n_levels", "8",
    "--model.finest_resolution", "256",
    "--model.temporal_partitioning", "none",
    "--model.camera_embedding_dim", "0",

    "--training.max_steps", "200",
    "--training.samples_max_batch_size", "65_536",
    "--training.rays_initial_batch_size", "1024",
    "--training.save_checkpoint_every_n_steps", "100",
    "--validation.every_n_steps", "100",
    "--validation.rays_batch_size", "1024",
    "--validation.repeat_cameras", "1",

    "--tpu.samples_per_ray", "512",
    "--tpu.synthetic_presets", "true",

    "--dataset.actor", "SynthActor",
    "--dataset.sequence", "Sequence1",
    "--dataset.scale", "1",
    "--dataset.crop_center_square", "false",
    "--dataset.filter_light_bloom", "false",
    "--dataset.max_buffer_size", "16",
    "--dataset.max_num_frames_per_batch", "2",
    "--dataset.frame_numbers", "0", "1",
    # fmt: on
]
