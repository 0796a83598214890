"""Runtime layer (`mpcc_manipulator_tpu/runtime/`): track generators, the
native telemetry library, checkpoints, the simulator bridge and the demo
command lines."""
