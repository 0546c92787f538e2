"""The general drivers: one per kind of driving loop. A traffic mix's file
names its driver; the driver reads every size and rate from that file."""
