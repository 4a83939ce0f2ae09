from .engine import (BETSchedule, BetEngine, ComposedPolicy, ExpansionPolicy,
                     FixedSteps, NeverExpand, StageEnd, StageInfo,
                     StageRecords, TwoTrack)
from .timemodel import SimulatedClock
from .trace import Point, Trace
