// The flow chain of flow_chain.cu, built to record a per-layer timeline
// (clock64() at up to six points of every layer in every CTA, and each CTA's
// entry and exit) and with a probe that times grid barriers alone.
// chip_smoke.py builds it beside the plain library and reads both to split a
// chain's time; nothing else loads it.
#define FLOW_CHAIN_TIMELINE
#include "flow_chain.cu"
