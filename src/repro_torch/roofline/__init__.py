"""The roofline layer: work models of the kernels' functions, the work
ledger and collective records of a run (the counterpart of the JAX
package's HLO parse), and the three-term report on a card's figures."""

from repro_torch.roofline import report, trace, work
from repro_torch.roofline.report import RooflineReport, build_report
from repro_torch.roofline.trace import record

__all__ = ["trace", "work", "report", "RooflineReport", "build_report",
           "record"]
