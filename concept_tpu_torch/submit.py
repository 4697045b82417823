"""Job submission: batch scripts for Slurm and TORQUE/PBS (port of
concept_tpu/submit.py; host only).

The reference launcher's job-submission layer (reference concept:835-847
scheduler detection, 2315-2660 job-script construction; Slurm header
concept:2411-2447, TORQUE/PBS header in the same range).  The reference
wraps `mpiexec -n N python -m main`; here a job is one process driving
the node's card, so the generated script re-invokes `python -m
concept_tpu_torch` with the same arguments minus the submission flags.
The script is written to `job/<id>/jobscript` and handed to sbatch/qsub;
`-u watch <id>` then follows its log, as the reference's util/watch
does.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys


def detect_scheduler() -> str | None:
    """'slurm' | 'torque' | None (reference concept:835-847: prefers
    sbatch over qsub when both are present).  Overridable for tests via
    CONCEPT_TPU_SCHEDULER."""
    forced = os.environ.get("CONCEPT_TPU_SCHEDULER")
    if forced:
        return forced if forced in ("slurm", "torque") else None
    if shutil.which("sbatch"):
        return "slurm"
    if shutil.which("qsub"):
        return "torque"
    return None


def _strip_submit_args(argv: list[str]) -> list[str]:
    """Remove submission-only flags from argv so the generated script
    runs locally (the reference's job script passes --local,
    concept:2588)."""
    out: list[str] = []
    skip = 0
    taking_value = {"-q", "--queue", "-w", "--walltime", "--memory",
                    "-J", "--job-name", "--job-directive"}
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a == "--submit":
            continue
        if a in taking_value:
            skip = 1
            continue
        if any(a.startswith(f + "=") for f in taking_value):
            continue
        out.append(a)
    return out


def build_job_script(
    scheduler: str,
    argv: list[str],
    jobname: str,
    logfile: str,
    errfile: str,
    queue: str | None = None,
    walltime: str | None = None,
    memory: str | None = None,
    nprocs: int | str = 1,
    directives: list[str] | None = None,
) -> str:
    """Render the batch script text.  Header layouts follow the
    reference's Slurm/TORQUE-PBS templates (concept:2411-2447): job
    name, queue/partition, node/task geometry, walltime, memory, and
    combined log path, then the run command."""
    if isinstance(nprocs, str):
        # '-n AxB' 2D mesh form: the scheduler geometry wants the total
        ns = nprocs.lower()
        total = 1
        for v in ns.split("x"):
            total *= int(v)
        nprocs = total
    lines = ["#!/usr/bin/env bash"]
    if scheduler == "slurm":
        lines += [
            f"#SBATCH --job-name={jobname}",
            "#SBATCH --nodes=1",
            "#SBATCH --ntasks-per-node=1",
            f"#SBATCH --cpus-per-task={max(1, nprocs)}",
            f"#SBATCH --output={logfile}",
            f"#SBATCH --error={errfile}",
        ]
        if queue:
            lines.append(f"#SBATCH --partition={queue}")
        if walltime:
            lines.append(f"#SBATCH --time={walltime}")
        if memory:
            lines.append(f"#SBATCH --mem={memory}")
        for d in directives or []:
            lines.append(f"#SBATCH {d}")
    elif scheduler == "torque":
        lines += [
            f"#PBS -N {jobname}",
            f"#PBS -l nodes=1:ppn={max(1, nprocs)}",
            f"#PBS -o {logfile}",
            f"#PBS -e {errfile}",
        ]
        if queue:
            lines.append(f"#PBS -q {queue}")
        if walltime:
            lines.append(f"#PBS -l walltime={walltime}")
        if memory:
            lines.append(f"#PBS -l mem={memory}")
        for d in directives or []:
            lines.append(f"#PBS {d}")
        lines.append('cd "$PBS_O_WORKDIR"')
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    run_argv = _strip_submit_args(argv)
    cmd = " ".join(
        shlex.quote(a)
        for a in [sys.executable, "-m", "concept_tpu_torch", *run_argv, "--local"]
    )
    lines += ["", cmd, ""]
    return "\n".join(lines)


def submit(args, argv: list[str]) -> int:
    """Generate job/<id>/jobscript and hand it to the scheduler
    (reference concept:2634-2660).  With no scheduler on PATH the
    script is still written and its path printed, so it can be
    submitted by hand (the reference aborts here)."""
    scheduler = detect_scheduler()
    job_dir = "job"
    os.makedirs(job_dir, exist_ok=True)
    existing = [int(d) for d in os.listdir(job_dir) if d.isdigit()]
    jobid = max(existing, default=-1) + 1
    d = os.path.join(job_dir, str(jobid))
    os.makedirs(d, exist_ok=True)
    logfile = os.path.abspath(os.path.join(d, "log"))
    errfile = os.path.abspath(os.path.join(d, "log_err"))
    jobname = args.job_name or (
        os.path.splitext(os.path.basename(args.param))[0] if args.param
        else "concept_tpu_torch"
    )
    script = build_job_script(
        scheduler or "slurm",
        argv,
        jobname=jobname,
        logfile=logfile,
        errfile=errfile,
        queue=args.queue,
        walltime=args.walltime,
        memory=args.memory,
        nprocs=args.nprocs,
        directives=args.job_directive,
    )
    path = os.path.join(d, "jobscript")
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, 0o755)
    if args.param and os.path.exists(args.param):
        shutil.copy(args.param, os.path.join(d, "param"))
    if scheduler is None:
        print(
            f"no scheduler (sbatch/qsub) found; job script written to {path}",
            file=sys.stderr,
        )
        return 1
    submit_cmd = os.environ.get(
        "CONCEPT_TPU_SUBMIT_CMD",
        "sbatch" if scheduler == "slurm" else "qsub",
    )
    proc = subprocess.run(
        [*shlex.split(submit_cmd), path], capture_output=True, text=True
    )
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode == 0:
        print(f"job {jobid} submitted via {scheduler} ({path})")
        print(f"follow it with: python -m concept_tpu_torch -u watch {jobid}")
    return proc.returncode
