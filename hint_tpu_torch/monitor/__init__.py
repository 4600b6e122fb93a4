from hint_tpu_torch.monitor.console import ConsoleMonitor, NullMonitor, make_monitor

__all__ = ["ConsoleMonitor", "NullMonitor", "make_monitor"]
# the matplotlib-backed pieces live in hint_tpu_torch.monitor.plots
# (FileMonitor, plot_sample_curves) and hint_tpu_torch.monitor.figures (paper
# figures); they import matplotlib only when they draw
