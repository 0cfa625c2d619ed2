"""The protocol drivers: the port's counterparts of the JAX package's
long-run scripts under `scripts/`. Each runs the port's CLI (`python -m
humanrf_torch.run`) with the JAX driver's flags, defaults, output files and
result keys, so the two can be read side by side.

- `full_schedule`: the 50k-step reference protocol on the r4 scene
  (`scripts/full_schedule_run.py`), `--dense` for the paper's sampler;
- `finish_phases`: the evaluate and trajectory phases from a workspace's
  best.ckpt (`scripts/finish_phases.py`);
- `quality_at_capacity`: the capacity sweep (`scripts/quality_at_capacity.py`);
- `multiseg`: the 100-frame, four-segment run (`scripts/multiseg_fsdp_run.py`);
- `drift_ablation`: weight-decay arms resumed from best.ckpt
  (`scripts/drift_ablation.py`);
- `parallax_probe`: PSNR against the angle to the nearest training camera
  (`scripts/parallax_probe.py`);
- `throughput_probe`: steps per second at the protocol shape, resumed from
  step 50,000 (`scripts/throughput_probe.py`);
- `metric_style`: masked against ROI PSNR on the same renders
  (`scripts/metric_style_decomposition.py`);
- `bank`: copies the small artifacts of the runs into `runs_evidence/`;
- `chain`: the sweep, then the schedule, each under its deadline
  (`scripts/protocol_chain.sh`);
- their plumbing: `validation_report`, `common`, `supervisor`.

Every driver runs on the card unless it is given `--device cpu`.
"""
