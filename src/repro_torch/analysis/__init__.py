"""The analysis tier of the port: analytic counters (``counters``), the
collective record of a mesh (``comms``) and the roofline report of a dry
run (``roofline``)."""
