# The paper's primary contribution: Batch-Expansion Training schedules
# (Alg. 1/3), the parameter-free Two-Track controller (Alg. 2), the DSM and
# mini-batch baselines, the §4.2 simulated time model, and Thm 4.1 algebra —
# all driven by the unified policy engine in engine.py.
from .engine import (BETSchedule, BetEngine, ComposedPolicy, ExpansionPolicy,
                     FixedSteps, GradientVariance, NeverExpand, ResumeState,
                     StageEnd, StageInfo, StageRecords, TwoTrack,
                     variance_stats)
from .dsm import run_dsm, run_minibatch
from .timemodel import SimulatedClock
from .trace import Point, Trace
from . import theory
