"""The device merge path of the TCP transport: the host↔card handoff
(:mod:`.handoff`), the device-resident replica with its lazy host mirror
(:mod:`.replica`) and the merge engine over B2 (:mod:`.engine`)."""
