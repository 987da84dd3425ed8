# Shared host-side helpers of the port.
