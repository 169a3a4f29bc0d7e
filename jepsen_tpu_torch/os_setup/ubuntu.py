"""Ubuntu node preparation (the port's copy of
jepsen_tpu/os_setup/ubuntu.py): the Debian flows with a different package
set.

Capability reference: jepsen/src/jepsen/os/ubuntu.clj (whole file; it
delegates hostfile/update/install to os/debian.clj).
"""

from __future__ import annotations

from . import debian

PACKAGES = [
    "apt-transport-https", "wget", "curl", "vim", "man-db", "faketime",
    "ntpdate", "unzip", "iptables", "psmisc", "tar", "bzip2",
    "iputils-ping", "iproute2", "rsyslog", "sudo", "logrotate",
]


class Ubuntu(debian.Debian):
    packages = PACKAGES


os = Ubuntu()
